#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bigdl_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

(``python3 chip_smoke.py --dp-child DIR`` is one rank of phase 10,
``--zero-child DIR`` one of phase 10b, ``--elastic-child SPEC`` one
process of phase 21's drill, ``--pipe-seq-child DIR`` one rank of
phase 24, ``--layouts-child DIR`` one of phase 25,
``--serve-layouts-child DIR`` one of phase 26,
``--axes-layouts-child DIR`` one of phase 27 and
``--mixed-layouts-child DIR`` one of phase 29, started by the script
itself;
``python3 chip_smoke.py --only train_validate`` runs the build and phase 13
alone, ``--only train_longrun`` the build and phase 14 alone,
``--only train_records`` the build and phase 15 alone, ``--only
data_parallel`` the build and phases 9, 10 and 10b, ``--only train_ptb``,
``--only layers``, ``--only train_zoo``, ``--only zoo_data``, ``--only
serve_stack``, ``--only elastic_fleet``, ``--only observe``, ``--only
train_moe``, ``--only pipe_seq``, ``--only layouts``, ``--only
serve_layouts``, ``--only axes_layouts``, ``--only interop`` and ``--only
mixed_layouts`` the build and phase 16, 17, 18, 19, 20, 21, 22, 23, 24,
25, 26, 27, 28 or 29 alone,
and none of them prints the final line.  Every phase is followed by a
line with its wall seconds, ``{"phase": ..., "phase_s": ...}``, and the
whole run by ``{"script_s": ...}``.)

Phases, each printing one JSON line:

1. ``build``: compile every CUDA source of the port with ``nvcc`` (one
   process per source, all started together), and the host libraries
   (``csrc/host``) with the host compiler beside them, and report the
   seconds and, by source and kernel, its registers and spilled bytes.
2. ``kernels``: hold the flash-attention kernels (B6) against their plain
   PyTorch version on the card, at the shapes the serving path gives them
   (D = 64) and at D = 16, 32 and 128, each in bf16 (the ``"tc"`` route:
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
   step gives the collectives' share.  Then the same ``TRAIN_STEPS`` of
   SGD with momentum from one saved state under deterministic cuDNN in
   each of ``DP_ROUTES``: ``DataParallel`` per leaf, ``DataParallel`` with
   ``BIGDL_TORCH_WIRE_BUCKET_MB=25`` (one all-reduce per bucket, launched
   from the backward), ``ShardedDataParallel`` (ZeRO) and ZeRO with
   ``BIGDL_TORCH_FUSED_UPDATE=1``: losses, parameters and buffers
   bit-equal across the routes (after one untimed step that lets cuDNN
   pick its deterministic algorithms), B3, B4 and B5 launches exactly as
   above,
   the collectives exactly as predicted from ``bucket_count`` and the ZeRO
   plan; each route's step time, profiled device idle share, peak memory,
   method-state bytes and ``measure_collective_seconds`` (0.0 at a world
   of one).
10. ``dp_two_process``: two processes on the one card in a gloo group (NCCL
   refuses two ranks on one GPU) train the small bottleneck ResNet in
   float32 (TF32 off, no gradient wire, B5 on ``"f32"``) for 3 steps at
   local batch 8;
   one process trains it at batch 16 on the same rows, all with SGD and
   momentum.  The ranks train it in each of ``DP_CHILD_ROUTES``
   (``DataParallel``, ZeRO at ``min_size`` 256, ZeRO with the fused
   update, ``DataParallel`` in buckets).  For each: losses, params and
   running statistics within ``DP_F32_ATOL`` of the one process, both
   ranks bit-identical, each rank's B3, B4 and B5 launch counts non-zero,
   its method-state bytes exactly the plan's and its collectives exactly
   as predicted.  Each rank times ``measure_collective_seconds`` at world
   2, and runs ``Predictor`` and ``Evaluator`` under the group over 13 rows
   at batch 5: both ranks' answers equal one process's (TF32 off) within
   ``INFER_TOL``.
10b. ``zero_full_width``: two gloo ranks on the card train ResNet-50 at
   the ``resnet50_bf16`` width (bf16 compute, fused) with Adam for
   ``ZERO_STEPS`` steps at ``ZERO_BATCH`` images a rank, under
   ``DataParallel`` and under ``ShardedDataParallel`` in the order A, B,
   B, A: losses, parameters, buffers and the whole final Adam state
   bit-identical across the routes, the repeats and the ranks, each
   rank's Adam state exactly the plan's bytes (half of each sliced leaf's
   two slots and all of the replicated leaves'), the collectives exact;
   the saving, the peak memory, the steps' time alone and the final
   state's gather of each route, beside the collectives gloo runs them
   with.
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
   causal (and not causal, and at D = 16, 32 and 128) and at float32 and
   bf16 ragged shapes (D = 16, 32, 128; Tq != Tk), each given the output and
   log-sum-exp of B6 on the same operands, within ``B7_TOL`` and
   bit-identical over two calls, timed beside the plain version and the
   backward of ``scaled_dot_product_attention``.

13. ``train_validate``: the training driver's everyday half on the card.
   The checkpoint frame's CRC32C must take its compiled route
   (``csrc/host/crc32c.cc``, built by the host compiler; a failed build
   fails the phase).  cuDNN is set deterministic for items (a) and (b), so
   that two uninterrupted runs can be bit-equal.
   (a) ResNet-50 as in ``train`` (batch 256, bf16, fused), ``SGD(0.1,
   momentum=0.9, weight_decay=1e-4)`` under ``MultiStep([4], 0.1)``, 2
   epochs of 3 batches, ``set_validation(every_epoch, 512 held-out
   images, [Top1Accuracy, Top5Accuracy, Loss(CrossEntropyCriterion)],
   256)``, ``set_checkpoint(every_epoch, keep_last=1)``, run twice
   uninterrupted.  Every step launches exactly what a ``train`` step
   does, on the same routes; the validation forwards launch none of B1
   to B5, leave every buffer bit for bit and the model in training mode;
   the last validation equals ``Evaluator(model).test`` on the same
   weights (counts equal, the loss within ``TV_EVAL_RTOL``); every
   snapshot passes ``file_io.verify`` and loads bit-equal to the live
   model's reference tree; retention leaves one pair.  A fresh Optimizer
   resumes from the epoch-1 pair (its dataset shuffled once, the
   permutation the snapshot does not hold) and runs epoch 2: its losses
   and validation equal the uninterrupted run's bit for bit where the two
   uninterrupted runs are, else inside their spread (``resume_rule``).
   (b) The bench-width LM (batch 16 x 512, bf16), ``Adam(1e-3)`` clipped
   at an L2 norm of 1.0, validation (``Loss``, ``Perplexity`` over 2
   batches of 4 x 512) and a snapshot after every 2nd iteration, 4 steps,
   twice; 8 B6 launches with the log-sum-exp and 16 B7 a step, 8 B6
   without it and no B7 a validation batch; resumed from the iteration-2
   pair, steps 3 and 4 under the same rule.
   (c) The float32 small LM with dropout 0.1: resumed steps 3 and 4 bit-
   equal to the uninterrupted run (the Dropout generator's state rides
   the snapshot).  (d) ``SGD`` (nesterov), ``Adam``, ``Adagrad``,
   ``Adadelta``, ``Adamax``, ``RMSprop``: 3 steps of the float32 small LM
   on the card and on the CPU (TF32 off, no wire), losses within
   ``F32_TRAIN_ATOL``; the method's update run on the card with the CPU
   run's gradients, parameters within ``TV_METHOD_RTOL`` of the CPU's
   (the trained parameters' difference is reported: see ``tv_methods``).
   (e) The README's quick start: ``LeNet5`` on
   synthetic MNIST, ``Adam(3e-3)``, 8 epochs at batch 64, Top1 validation
   and a snapshot every epoch: loss under 1.0, Top1 at least 0.95, none
   of the repo's kernels launched.  Reports step ms beside ``train``'s,
   validation ms and images/s, snapshot bytes, write ms, verify-plus-load
   ms and resume ms.

14. ``train_longrun``: the training driver's long-run half on the card,
   cuDNN deterministic throughout (every gate here is bit for bit).
   (a) ResNet-50 as in ``train`` with ``set_gradient_accumulation(4)``:
   one step's gradients (after the wire) and BatchNorm buffers bit-equal
   to four hand-run microbatch backward passes summed in order and
   divided by 4; every microbatch shape through ``bn_kernels`` (B5 at R =
   64·7·7 = 3136, a ragged last 128-row tile, on ``"tc"``); 3 steps at
   exactly 80 B1, 80 B2, 132 B4 and 132 B5 a step on their step routes;
   the peak memory beside ``train``'s.  (b) The same model and batches
   with no remat, ``set_remat("conv_out")`` and ``"full"`` (one
   checkpoint per segment: the children of nested ``Sequential`` s), 3
   steps each: losses, parameters and buffers bit-equal, launches a step
   20 / 40 / 40 B1, 20 B2, 33 B4, 33 / 33 / 66 B5, and ``"full"``'s peak
   (over what the run found allocated) below no remat's.  (c) The
   bench-width LM, ``EMA(Adam(1e-3), 0.999)`` and a ``TrainSummary``, 4
   steps with ``set_remat("full")`` and without: losses bit-equal, 16 B6
   (all with the log-sum-exp) and 16 B7 a step under remat, the shadow
   within ``EMA_RTOL`` of the formula on host copies of the parameters,
   the summary's Loss equal to the observed losses; a float32 dropout LM
   (p = 0.1): one step's gradients under remat bit-equal to those
   without.  (d) ResNet-50 at batch 64 (2 batches an epoch in a fixed
   order, a snapshot after every 2nd iteration, 7 iterations): a failure
   at ``step.stall`` and a NaN at ``step.loss_nan`` at iteration 5 are
   recovered from snapshot 4 and the runs end bit-equal to an
   uninterrupted one; a NaN at iteration 1 restores the starting weights
   bit for bit; exhaustion raises the original error; three retries
   leave the stager's pinned bytes as one does; a supervised ``step``
   deadline catches a ``StallAt`` (a JSON crash report written) and a
   ``data`` deadline a stall in the prefetch worker, both recovered bit
   for bit; SIGTERM at iteration 4 gives that snapshot and
   ``TrainingPreempted``, and ``resume_from`` ends bit-equal.  (e)
   ResNet-50 at batch 256 with a snapshot every iteration, synchronous
   and asynchronous: every asynchronous pair bit-equal to the
   synchronous one, both runs timed; a registered in-process store
   behind ``RetryingFileSystem`` with ``FailN(2)`` on ``fs.remote``
   retries, writes and verifies the pair.  (f) LeNet-5's ``LBFGS``
   update on the card against the CPU's on the same gradients, within
   ``TV_METHOD_RTOL``; ResNet-50 with the stem's ``scale_w`` and
   ``scale_b`` at 0: the stem's parameters bit-equal after 3 steps, the
   rest trained.

15. ``train_records``: training from BDRecord shards. The host library
   (``csrc/host/recordio.cc``, ``prefetch.cc``, ``hostops.cc``) and the
   CRC32C must take their compiled routes, and the native shard
   prefetcher must open. Seeded uint8 ``.npy`` images in 10 class folders
   become shards through ``tools/record_generator.py`` ``convert`` (8
   shards each): 1536 at 256 x 256, 512 at 224 x 224, 384 at 32 x 32
   (records/s and bytes on disk). ResNet-50 as in ``train`` (fused, bf16,
   batch 256) trains from ``DataSet.record_stream(..., num_threads=8)``
   through a dict-to-``LabeledImage`` transformer (``data / 255``) and
   ``MTImageToBatch(256, RdmResizedCrop(224, 224) >> HFlip >> ColorJitter
   >> Lighting >> ImgNormalizer, drop_last=True)``, one epoch of 1 + 5
   steps, the window after step 1 timed (step ms, data wait and its
   share, images/s); the same through ``record_files(...,
   num_threads=8)`` (cached); ``DataSet.array`` of ready images beside
   them with the loss read every step and every 10th (A B B A); the
   pipeline alone (records/s, the MT batcher and the sequential chain);
   a profile of the streamed steps (busy, idle share). Every run exactly
   20 B1, 20 B2, 33 B4 and 33 B5 a step on ``"vec"`` / ``"tc"``. At
   batch 64 over the cached 224 set, ``set_drop_module_property(1/12,
   1/12, 12, 0)`` with one ``data.stall`` of 3 s at batch 7: exactly that
   iteration dropped, and the recorded waits replayed through a fresh
   Optimizer's ``_straggler_check`` give the same decisions. The zoo CLI
   (float32, unfused, cuDNN deterministic): ``run.main(["train",
   "--model", "resnet50", ...])`` 3 steps at batch 256 with
   ``--model-save``, exactly 53 B1 and 53 B2 a step on ``"vec"`` and no
   B4 or B5; ``run.main(["test", ...])`` launches none and gives Top1 and
   Top5 equal to ``Evaluator`` on the live model; ``--model resnet``
   (ResNet-20, shortcut A) 3 steps at batch 128, 19 B1 and 19 B2 a step.
   The CLI runs with PyTorch's default TF32 settings, as a fresh process
   does: cuDNN's float32 convolutions in TF32.
   LeNet-5 through the facade (``update_output``, ``backward``,
   ``update_parameters``) on the card and the CPU, float32, TF32 off,
   under cuDNN (default and deterministic) and PyTorch's own
   convolutions: every result within 1e-4 of the CPU's, but cuDNN's conv1
   weight gradient, which equals a lone cuDNN call's bit for bit and is
   within float32's summation bound of the exact one (its engine named
   from cuDNN's API log in a child process).

16. ``train_ptb``: the repo's ``lstm`` config trained on the card:
   ``PTBModel(10000, 200, 200, num_layers=2)`` (LookupTable, two
   ``Recurrent(LSTM)`` layers, ``TimeDistributed(Linear)``, LogSoftMax),
   weights from the seed, batch 64 x T 35 of seeded random tokens through
   ``DataSet.array`` -> ``Optimizer``, ``TimeDistributedCriterion(
   ClassNLLCriterion(), size_average=True)``, ``SGD(0.1)``, float32 with
   TF32 off, ``PTB_STEPS`` steps.  Every loss finite; a second run from
   the same seed bit-equal; the first 3 losses within ``PTB_CPU_ATOL`` of
   the same training on the host; no launch of any of B1 to B8 (the
   reference computes the LSTM in jnp under ``lax.scan``).  Reports each
   step's ms, the median after ``PTB_WARMUP`` steps and tokens/s, the
   peak memory (and its rise over what earlier phases left allocated),
   and over ``PTB_PROFILE_STEPS`` profiled steps the device's
   busy ms and idle share, kernel launches and copies a step, the host's
   ms a step (the window less its CUDA waits) and the most launched
   kernels.
17. ``layers``: every class this slice exported from ``bigdl_torch.nn``
   (activations, math, shape, table and elementwise-parameter layers,
   containers, ``GradientReversal``, the recurrent cells and wrappers,
   the criteria), built on the host at a small size from the seed and
   copied to the card: forward, input gradients and parameter gradients
   in eval mode (criteria: the loss and its gradients), float32 with TF32
   off, within ``LAYER_RTOL`` of the host's; the set of classes these
   cases reach must equal ``SLICE16_CLASSES``, all of them exported.
   ``RReLU`` in training: slopes inside [lower, upper], one generator
   state giving the same output twice.  ``SimpleRNN``, ``BiRecurrent(GRU)``
   and ``Autoencoder(32)`` with ``MSECriterion`` take ``SEQ_STEPS`` steps
   on the card and on the host, losses within ``SEQ_ATOL``.  The zoo CLI
   trains (``SEQ_STEPS`` steps) and tests ``--model autoencoder`` from
   BDRecord shards of seeded 28 x 28 x 1 images written by
   ``tools/record_generator.py``.  Then every class of slice 17 the same
   way (``LAYER17_CASES``; the classes reached must equal
   ``SLICE17_CLASSES`` too): the other convolutions
   (``SpatialFullConvolution`` with ``adj`` = stride among them), the
   extra normalizations, 3-D pooling, ``RoiPooling`` with tied maxima and
   empty bins, the conv LSTMs (the 3-D cell under ``Recurrent``), a
   ``Graph`` with a diamond, ``BinaryTreeLSTM`` on two trees of different
   shapes and ``Nms`` with tied scores; and ``nms`` on the card under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host read inside its
   loop), equal to the host's.  None of B1 to B8 launches.
18. ``train_zoo``: the image and text zoo on the card, each run
   ``ZOO_STEPS`` steps through ``DataSet.array`` -> ``Optimizer`` on
   ``ZOO_BATCHES`` seeded batches, weights from the seed; each step's ms
   from CUDA events and the median after ``ZOO_WARMUP``, images (or
   samples) a second, the peak memory over what the run found
   allocated, and a profile of ``ZOO_PROFILE_STEPS`` steps (busy ms,
   idle share, launches a step).
   (a) bench.py's ``inception_v1`` config at full width:
   ``Inception_v1_NoAuxClassifier(1000)``, batch 64 x 224 x 224 x 3,
   float32, ``ClassNLLCriterion``, ``SGD(0.1)``, under PyTorch's default
   TF32 settings (cuDNN's convolutions in TF32, cuBLAS's products not;
   the line says so).  Every loss finite, no launch of B1 to B8; the
   first ``ZOO_CPU_STEPS`` losses of a leg with TF32 off and Dropout at
   p = 0 within ``ZOO_CPU_ATOL`` of the same steps on the host.
   (b) BN-Inception at full width on the training kernels:
   ``Inception_v2_NoAuxClassifier(1000)`` under ``fuse_conv_bn``, batch
   64 x 224 x 224 x 3, bf16 compute over float32 params, ``SGD(0.1,
   momentum=0.9)``.  A warm-up step records every shape the step gives
   B1, B2, B4 and B5, exactly ``BNINC_STEP_LAUNCHES`` a step (32 B1,
   32 B2, 37 B4, 37 B5) on ``"vec"`` / ``"tc"`` in ``BNINC_STEP_SHAPES``
   distinct shapes; ``bn_kernels`` holds each at every such shape (and
   B1 to B4 at (3136, 352)) to its plain version and times it beside its
   library call and bound; the timed run launches exactly 20 times the
   step's counts on the same routes and moves the running statistics.
   (c) bench.py's ``textcnn`` config at full width: ``TextClassifier(20)``,
   batch 128 x 500 x 200, float32, ``SGD(0.05)``, default TF32 settings;
   every loss finite, no launch of B1 to B8, and the first 3 losses of a
   TF32-off leg within ``ZOO_CPU_ATOL`` of the host's.
19. ``zoo_data``: the zoo's last models and the data half.
   (a) ``ViT()`` at its ImageNet defaults (224², patch 16, d_model 384, 6
   heads of 64, 8 layers, 1000 classes), batch 128, bf16 compute over
   float32 params, ``SGD(0.01, momentum=0.9)``, ``ZOO_STEPS`` steps
   through ``Optimizer`` on seeded images (median step ms after
   ``ZOO_WARMUP``, images/s, peak memory, a profile of 5 steps): exactly
   8 B6 writing the log-sum-exp and 16 B7 a step, all ``"tc"``, no other
   kernel of the repo; an eval forward through ``Predictor`` 8 B6
   without it a batch; B6 (both instances) and B7 at [128, 6, 196, 196,
   64] bf16, not causal (T = 196: a ragged second tile both ways), held
   to their plain versions and timed beside SDPA and its backward and
   the bound; a float32 leg (batch 8, TF32 off, ``"f32"``) whose first 3
   losses are within ``ZOO_CPU_ATOL`` of the host's.
   (b) the zoo CLI's ``vit`` (heads of 16) trained 3 iterations from a
   BDRecord shard as the CLI trains (float32): finite losses, 4 B6 and 8
   B7 an iteration on ``"f32"``; B6 and B7 at its call [32, 4, 64, 64,
   16] on both routes against their plain versions.
   (c) ``bench.py``'s ``widedeep`` config: ``FeatureSpec()``, 512 seeded
   records through ``TabularToSample``, ``WideDeep.from_spec(spec,
   embed_dim=64, hidden=(256, 128))``, batch 512, float32,
   ``SGD(0.05)``: no kernel of the repo, the TF32-off leg within
   ``WD_CPU_ATOL`` of the host's; then ``DLClassifier.fit`` for an epoch
   and ``UDFPredictor``'s rows over the model it trained equal to
   ``Predictor``'s bit for bit.
   (d) ``quantize(TransformerLM)`` at the serve width: its weight bytes
   beside the float model's; 16 requests through ``InferenceServer``
   (8 B6 ``"tc"`` a device batch, answers within ``SERVE_ATOL`` of its
   ``Predictor``); the decode workload through ``DecodeEngine`` with its
   graphs, for the int8 model and the float one (B8 ``"bf16"``, 8 x
   (prompt positions + ticks), warm rows equal to cold), the int8 rows
   equal to its ``cached_generate`` under the tie rule; each engine's
   warm tokens/s and its graph tick's device time; B6 and B8 at their
   calls against their plain versions.
   (e) 2 SequenceFile shards of 28² images written on the host, streamed
   through ``DataSet.seq_file_folder`` into 3 LeNet-5 steps on the card;
   ``python -m bigdl_torch.tools.perf`` for ``inception_v1`` and
   ``resnet50`` at batch 64, 5 iterations, each its own process, beside
   the rates ``train_zoo`` and ``train`` measured in the same run.
20. ``serve_stack``: the serving stack in one process at the serve width
   (bf16).  ``InferenceServer(lm, seq_buckets=(128, 256, 512),
   max_batch=8)`` with the replica monitor, generous tenant quotas,
   autoscaling to 2 replicas and the offered traffic recorded.
   (a) A second copy of the LM trains ``SS_TRAIN_STEPS`` steps at batch 16
   x 512 through ``Optimizer(...).set_checkpoint(dir, every_done(2),
   publish=True)`` (B6 with its log-sum-exp and B7 on ``"tc"``); a
   ``DeployController`` canaries its release at 0.25 of the batches under
   rounds of 8 requests from two tenants and promotes it; a lone request
   after the promotion equals the promoted version's own forward bit for
   bit; a release whose snapshot was rewritten after publication is
   refused (fingerprint) and quarantined, one whose canary batches
   ``serve.canary`` faults is rolled back, the version stays; a plain
   swap is timed to its first answer.  (b) ``serve.replica@0`` ends the
   replica: the monitor restarts it and every request is answered; a
   LeNet-5 server with a budget of 1 spends it and turns unhealthy.
   (c) A burst of ``SS_BURST`` requests grows the pool 1 -> 2, idling
   shrinks it back.  (d) The recorded traffic is replayed at 10x (SLO
   attainment per tenant); the same scoring workload runs with the tracer
   off and on, whose Chrome trace must hold ``serve.batch`` spans and a
   request flow per request.  Every scoring answer is within
   ``SERVE_ATOL`` of ``Predictor`` on the weights of the version that
   answered it, and the B6 launches are exactly 8 a device batch (every
   version's warm-ups included), a forward beside the server, or a
   trainer's step, all ``"tc"``.  (e) ``serve_http.serve_forever`` over
   the server with a ``DecodeEngine`` of the same LM: 8 prompts through
   ``POST /v1/generate`` from 8 threads (B8 exactly 8 x (prompt positions
   + ticks) on ``"bf16"``, no graph captured, rows equal to the engine's
   and to ``cached_generate`` under the tie rule), recorded by the
   ``X-BigDL-Record-Trace`` header; ``/healthz``, ``/v1/stats``,
   ``/v1/versions`` and ``/metrics`` all 200.  (f) ``python -m
   bigdl_torch.tools.serve_http --generate`` as a child answers predict,
   generate and a swap to a LeNet-5 module file, then drains on SIGTERM
   and exits 0; ``python -m bigdl_torch.tools.serving_bench`` at the serve
   width.  B6 at [8, 8, 128, 64] and the trainer's [16, 8, 512, 64] with
   the log-sum-exp, B7 at the trainer's, B8 at the engine's: each held to
   its plain version and timed.
21. ``elastic_fleet``: elastic training and the serving fleet, each
   process of them on the card.
   (a) Shrink: two processes of this script (``--elastic-child``), the
   logical ranks of ``BIGDL_TORCH_ELASTIC_WORLD=2``, each train the LM at
   the bench width on its half of ``EF_SAMPLES`` sequences at 16 x 512
   (``Adam(EF_LR)``, the order pinned, ``PREFETCH_DEPTH=0``, a snapshot
   after every iteration, rank 0 publishing a release of each).  Before
   each step a barrier over a shared dir holds a rank until every
   survivor has finished the previous iteration (the wait of a
   data-parallel step's collective).  Rank 1 carries
   ``host.lost@1=exit@1:3`` and exits 117; rank 0, parked in the barrier,
   must detect the silence (``EF_PEER_LOST`` s), negotiate the newest
   entry, shrink to world 1 at 32 x 512 and train on.  (b) Grow: rank 1
   comes back as a joiner (``BIGDL_TORCH_ELASTIC_JOIN=1``,
   ``host.return@1=join@2:2``): it waits for its death certificate,
   announces itself and is admitted at rank 0's next checkpoint
   boundary; both train ``EF_AFTER_GROW`` more iterations.  History:
   world 2 -> 1 -> 2, batch 16 -> 32 -> 16.  Clean processes, each run
   twice, resume from the shrink's entry (world 1, to the grow's) and from
   the grow's (each rank of world 2, to the end); rank 0's and the
   joiner's losses are held to theirs under ``resume_rule``.  Every step
   of every run: 8 B6 (each with the log-sum-exp) and 16 B7 launches, all
   ``"tc"``.  Release ids are gap-free across both resizes and a
   stub-served ``DeployController`` promotes the releases from the grow
   on (earlier snapshots the drill's retention pruned).  Printed:
   detect-to-resume, negotiate and re-form ms from rank 0's trace, the
   joiner's announcement-to-resume ms, the step ms at each world, the
   ``elastic.*`` events.  B6 with the log-sum-exp and B7 at the shrunk
   world's [32, 8, 512, 64] bf16 causal, held to their plain versions
   and timed beside SDPA and the bound.  (c) Fleet: a ``FleetSupervisor``
   spawns 3 ``python -m bigdl_torch.tools.serve_worker`` members serving
   LeNet-5 on the card, beside a stale ``member.7.1`` record with no
   heartbeat; ``EF_REQUESTS`` requests replay through ``FleetFront`` while
   member 0 takes ``kill -9`` and member 1's first life carries
   ``fleet.member@1=wedge@80`` (the zombie): both are condemned and
   respawned at generation 2, no accepted request is lost, the stale
   entry is never routed, every answer is within ``SERVE_ATOL`` of
   ``Predictor``.  A release rolls out through ``DeployController`` in
   fleet mode (canary ``EF_CANARY`` on the lowest member, then at most 1
   member swapping at a time) under closed-loop traffic, and every
   member's answers are then within ``SERVE_ATOL`` of ``Predictor`` on
   the release.  Printed: requests answered, retried and shed,
   respawn-to-ready s, the deploy's s, p50 and p99 ms through the front
   against one member called directly.

22. ``observe``: the observability modules on the bench LM (the
   ``train_lm`` width and batch), traced (``BIGDL_TORCH_TRACE`` set to a
   temporary dir).  ``measure_roofline()`` (chains of bf16 8192^3
   ``torch.matmul`` products) must give a number, printed as TFLOP/s and
   as a share of the ``utils/flops.py`` table's peak.  ``OB_STEPS``
   traced steps: 8 B6 (each with the log-sum-exp) and 16 B7 a step on
   ``"tc"``; every step's ``train`` track carries ``model_flops_per_step``
   equal to the LM step's closed form (3 x 2 x tokens x in x out over
   every ``Linear`` and the attention's four E x E projections, plus
   12·B·H·T²·D per attention layer) and ``0 < mfu <= 1``.
   ``measure_step_seconds`` of the step within ``OB_TIMING_RATIO`` of
   the same steps read from CUDA events of their own (``events_of_
   measured``), and the step run under a FLOP count timed.
   ``ModuleProfiler`` over one forward and backward: a non-zero forward
   time for every leaf with parameters, a non-zero backward time for
   every ``Linear``.  ``trace_steps`` over 3 steps: the 10 kernels with
   the most device time printed, B6's and B7's among the trace's kernels.
   ``python -m bigdl_torch.tools.trace_report DIR --json`` exits 0 with
   ``step`` among its phases and ``train.mfu`` among its counters.
   ``memory_record``'s peak bytes printed.  B6 with the log-sum-exp and
   B7 at the step's [16, 8, 512, 64] held to their plain versions.
23. ``train_moe``: the ``transformer_moe`` config of ``bench.py`` (vocab
   16000, T 256, d_model 512, 8 heads, 4 layers, 8 experts of hidden 2048,
   k = 1, capacity factor 1.25, batch 16, bf16 compute; seeded random
   weights; sequences that count up modulo ``MOE_PERIOD`` from a random
   start, so 20 steps have something to learn) trained ``MOE_STEPS``
   steps through ``DataSet.array`` -> ``Optimizer`` as ``train_lm``
   trains, traced: the first loss near ln 16000, every loss finite, the
   last ``MOE_MIN_DROP`` below the first; 4 B6 (each with the
   log-sum-exp) and 8 B7 a step on ``"tc"``;
   every step's ``mfu`` in (0, 1].  One MoE layer's routing
   (``top_k_routing``) on the card bit-equal, in its one-hot masks, to
   the CPU route's on the same float32 logits.  B6 with the log-sum-exp
   and B7 at [16, 8, 256, 64] causal held to their plain versions and
   timed beside SDPA and the bound.
24. ``pipe_seq``: pipeline and sequence parallelism.  (a) One process:
   ``bench.py``'s ``transformer_lm_pipe`` width (vocab 16000, T 256,
   d_model 512, 8 heads, 8 layers, batch 16, bf16 compute, seeded
   weights) partitioned by ``partition_pipeline(model, 2)``, which
   without a ``pipe`` axis runs its stages in turn: ``PS_STEPS`` losses
   bit-equal to the unpartitioned LM's from the same weights and batches,
   and the trained stack's rows bit-equal to its trained blocks (the rest
   of the weights too), 8 B6 (each with the log-sum-exp) and 16 B7 a
   step on ``"tc"``.  The
   dense LM at the ``transformer_lm`` width (vocab 32000, T 512) gives
   its log-probs on fixed tokens and ``PS_STEPS`` losses.  (b) Two gloo
   ranks on the one card, one spawn (``--pipe-seq-child``): the same
   pipelined config on ``Engine.init(mesh_shape={"pipe": 2})`` under
   ``gpipe``, ``1f1b`` and ``1f1b`` v = 2 with 4 microbatches, traced:
   losses within ``PS_LOSS_TOL`` of (a)'s and equal on both ranks, the
   trained weights bit-equal on both ranks and each unit's (the
   embeddings, each block's attention and feed-forward, the head) change
   over the run within ``PS_DELTA_TOL`` of (a)'s (the bf16 losses of
   random tokens move at most an ulp, 0.0625, in 5 steps, so they cannot
   see a wrong gradient), every
   step's ``train`` track ``pipe_bubble_fraction`` equal to
   ``bubble_fraction(2, 4, schedule, v)``, each rank's live-stash peak
   equal to the table's (``peak_inflight_per_device``), the per-rank
   launches of ``PS_PIPE_STEP``; then the group re-formed as
   ``{"seq": 2}``: ``TransformerLM(seq_parallel=True)`` at the
   ``transformer_lm`` width with the dense LM's weights, its log-probs
   within ``KERNEL_TOL`` of the dense LM's and its losses within
   ``PS_LOSS_TOL`` of the dense LM's, equal on both ranks, its trained
   weights bit-equal on both ranks and each unit's change within
   ``PS_DELTA_TOL`` of the dense LM's, with the
   per-rank launches of ``PS_SEQ_STEP`` (rank 0 holds the first query
   shard, so its causal ring skips the block above the diagonal); and
   ``ring_attention`` (causal and not) and ``ulysses_attention`` (causal)
   at [16, 8, 512, 64] bf16, whose output shards and q, k, v gradients
   must match one B6 / B7 call on the whole tensors within ``KERNEL_TOL``
   and ``B7_TOL``.  Printed: host step ms, tokens/s, run seconds and
   ``max_memory_allocated`` of every run, per rank; the tensors that
   went through host memory (``parallel/hops.py``).  B6 with the
   log-sum-exp and B7 at the pipeline's [4, 8, 256, 64] causal, the
   ring's [16, 8, 256, 64] not causal and Ulysses' [16, 4, 512, 64]
   causal held to their plain versions and timed beside SDPA and the
   bound.

25. ``layouts``: the mesh layouts.  One process trains the bench LM
   (16 x 512 bf16, SGD 0.01 with momentum, 5 steps; ``ps_train``) as the
   reference run; then four gloo ranks share the card (one spawn,
   ``--layouts-child``): the same LM from the same seed under
   ``LayoutSharding`` on ``MeshLayout(1, 2, 2)``, then on a new group
   ``(2, 2, 1)``.  Gates a rank and layout: (a) its parameter and
   momentum elements exactly ``LY_LOCAL`` (the role table's); (b) the
   gathered weights after the run bit-equal on the four ranks; (c) each
   unit's change within ``PS_DELTA_TOL`` of the one-process run's; (d)
   8 B6 (all with the log-sum-exp) and 16 B7 a step on ``"tc"`` at the
   rank's rows and heads (``LY_STEP``); (e) the Engine's collectives a
   step by kind, ``LY_COLLECTIVES``.  Under (1,2,2) after training:
   ``Predictor`` under the strategy on ``LY_PREDICT_ROWS`` sequences (8
   B6 without the log-sum-exp at [4, 4, 512, 64]) within
   ``LY_PREDICT_TOL`` of the one-process ``Predictor`` on the gathered
   weights; ``cached_generate(mesh=)`` of ``LY_PROMPT`` prompts in
   float32 (B8 on ``"f32"`` at [4, 4, 1, 64] queries over a [4, 4, 64,
   64] cache): tokens equal to one process's, log-prob rows within
   ``LY_DECODE_TOL``; then in bf16, timed.  ``TensorParallel`` over
   ``{"model": 2, "data": 2}``: tests/test_multihost_tp.py's MLP, 3
   steps in float32 with Adam and again with SGD (whose weights see the
   gradients' scale), losses and gathered weights within ``LY_TP_TOL``
   of one process's.  Printed: host ms a step per layout and rank, peak
   memory a rank beside the bytes the plan gathers whole (the largest
   unit's and all units'),
   tensors through host memory (``parallel/hops.py``), decode ms a step;
   B6 / B7 at the new shapes and B8 at [4, 4, 64, 64] on both routes held
   to their plain versions and timed beside SDPA and the bound.
26. ``serve_layouts``: serving on the mesh layouts, four gloo ranks on
   the card in one group on the Engine's (1,2,2) mesh (one spawn,
   ``--serve-layouts-child``), the bench LM from ``SEED``.  (R) A
   ``TopologyRouter`` of two (1,1,2) members over ranks {0,1} and {2,3}
   (``max_batch=8``, ``SEQ_BUCKETS``) led by rank 0: first in float32
   (8 requests, batches of 2), then 32 scoring requests of 100 to 512
   tokens in bf16; then 8 requests queued behind ``scale_to(1)``, 8
   more on the one member, ``scale_to(2)``, member 0 marked unhealthy
   and 16 requests.  Gates: every request answered, both members routed
   to, each answer within ``SL_F32_TOL`` (float32) or ``LY_PREDICT_TOL``
   (bf16) of the one-process ``Predictor`` (rank 0, a mesh of one) at
   its bucket, the drill's 16 all on member 1 and the pool healthy.
   (S) ``InferenceServer(mesh=Engine.mesh(), LayoutSharding,
   replicas=2)`` over the four ranks, two client threads, a swap to a
   second LM while they send: none lost, versions 1 and 2 answered, each
   answer within ``LY_PREDICT_TOL`` of its version's one-process
   ``Predictor``.  (D) ``DecodeEngine(mesh=Engine.mesh(), slots=8,
   page=16)``, continuous admission: in float32 6 sequences (prompts of
   8 to 16 tokens, 8 new), tokens equal to the one-process engine's and
   every sampled row within ``LY_DECODE_TOL``; then 12 in bf16, timed.
   Gates on every rank: B6 exactly 8 a batch its member ran (the
   leader's batch messages), none with the log-sum-exp, on ``"tc"``
   (``"f32"`` in float32) at 4 heads; B8 exactly 8 x (ticks + the
   prompt positions of the rank's block of slots) on the dtype's route
   at 4 heads; no CUDA graph under the mesh; nothing through ``hops``.
   Printed: each part's seconds a rank, the router's ``stats()
   ["router"]``, the decode tokens/s and busy ms a tick; B6 at [8, 4, T,
   64] bf16 causal (T of ``SEQ_BUCKETS``) and [2, 4, 512, 64] float32
   without the log-sum-exp, B8 at [4, 4, L, 64] (the rungs the run used)
   on both routes, held to their plain versions and timed beside SDPA
   and the bound.
27. ``axes_layouts``: the pipe, expert and seq axes beside the batch
   axes, four gloo ranks on the card (one spawn,
   ``--axes-layouts-child``), each run a group of its own, bf16, SGD
   0.01 with momentum, ``AX_STEPS`` steps of 16 rows from ``SEED``:
   ``transformer_lm_pipe`` (``pipe_seq``'s width) partitioned over 2
   stages under ``LayoutSharding`` on (2,1,1,2,1) with ``gpipe`` and
   with ``1f1b`` (4 microbatches of the rank's 8 rows); ``transformer_
   moe`` (``train_moe``'s width, the router's jitter off) on
   (2,1,1,1,2); the seq-parallel ``transformer_lm`` on ``{"data": 2,
   "seq": 2}``; the bench LM with ``BIGDL_TORCH_RING_ATTN=1`` on
   (2,1,2) (the attention rings over tp); the bench LM on (1,2,2), its
   weights gathered again in the backward.  The MoE LM trains twice
   (``AX_MOE_RUNS``, ``ax_data`` says why): on random tokens computing
   and sending its gradients in float32, and on ``train_moe``'s counting
   tokens in bf16, products and gradients sent; every other run trains on
   random tokens.  One process trains the unpartitioned pipelined LM,
   each MoE run (its records in the ranks' global order,
   ``ax_rank_major``) and the dense LM first.  Gates a rank and run: the
   gathered weights bit-equal on the four ranks; each unit's change
   within ``PS_DELTA_TOL`` of the one-process run's; B6 (and those with
   the log-sum-exp) and B7 launches a step exactly ``AX_LAUNCHES``' on
   ``"tc"`` (the float32 MoE run's on ``"f32"``) at the stated shape;
   the Engine's collectives a step exactly ``AX_COLLECTIVES``' (the
   pipe's hops from its tables, ``ax_pipe_hops``); the stage stack's and
   the expert tables' bytes on the rank exactly 1/2 of the whole and the
   rank's elements the whole less the half it does not hold; (1,2,2)'s
   elements ``LY_LOCAL``'s.  Printed: host ms a step and peak memory a
   rank of every run, the (1,2,2) peak beside the plan's whole bytes held
   at once (``held_peak``) and the 2.68 to 2.80 GB recorded before it
   (the layouts' runs without the re-gather, PERF.md), for each MoE run
   the tokens of a random-token probe batch it routes to another expert
   on the ranks than in one process as each step starts and after the
   last (``AxProbe``, counted apart from the run's launches and
   collectives); B6 with the log-sum-exp and B7 at the pipeline's [2, 8,
   256, 64] causal, the MoE LM's [8, 8, 256, 64] causal in float32 and
   in bf16 and the rings' [8, 8, 256, 64] not causal held to their plain
   versions and timed beside SDPA and the bound.
   ``CHIP_SMOKE_MOE_SPLIT=1`` adds the MoE runs of ``AX_MOE_SPLIT`` on
   random tokens (bf16; bf16 products with a float32 wire; float32
   products with a bf16 wire) and each MoE run's unit changes after
   every step, printed and not gated; ``CHIP_SMOKE_PLANT=expert_out``
   plants a fault in the ranks (``ax_plant_expert_out``), which the MoE
   gate must fail.
28. ``interop``: a BigDL user's migration (``examples/migrate_from_
   bigdl.py``, ``ModelValidator.scala``) at ResNet-50's full width.
   ``ResNet(50, class_num=1000, dataset="imagenet")`` from a seed on the
   card in float32 (TF32 off), one training forward of a seeded [32,
   224, 224, 3] batch (every BatchNorm on B1; its statistics move), then
   saved with ``interop.save_bigdl`` and ``save_caffe`` and read back on
   the card: each eval forward of another seeded batch within
   ``IP_FWD_TOL`` of the source's.  ``model_validator.validate`` of both
   files over ``IP_RECORDS`` seeded 224 x 224 records from the port's
   record writer, labelled with the source's top class (half of them) or
   its third (a quarter): Top-1 and Top-5 counts equal to ``Evaluator``'s
   on the source (at least 1/2 and 3/4).  The model loaded from the BigDL file (its structure read from
   the file again, unbuilt) and the source are fused as ``train`` fuses
   the bench's ResNet-50 and fine-tuned ``IP_STEPS`` Optimizer steps in
   bf16 at batch 32 on the same batches under deterministic cuDNN: the
   losses within ``IP_LOSS_TOL``, B1, B2, B4 and B5 launches exactly
   ``STEP_LAUNCHES`` a step on both, on ``STEP_ROUTES``.  The tuned model
   saved in the BigDL format reloads with its leaves and buffers bit-equal
   and no fused class in the file.  The five committed fixtures of
   ``tests/fixtures/interop`` load on the card and meet their tests'
   outputs; LeNet-5 through ``save_tf``/``load_tf`` and ``save_torch``/
   ``load_torch_module`` within ``IP_CHAIN_TOL``.  B1, B2, B4 and B5 at
   the fine-tune's largest call held to their plain versions and timed.
   Printed: the files' bytes, the host seconds of every save, load and
   validation, host ms a fine-tune step.
29. ``mixed_layouts``: the whole 5-axis layout, four gloo ranks on the
   card (one spawn, ``--mixed-layouts-child``), each run a group of its
   own, weights from ``SEED``, ``MX_RUNS`` in order: (M1)
   ``transformer_lm_pipe`` (``pipe_seq``'s width, bf16) in 2 stages on
   pipe x tp (1,1,2,2,1) under ``gpipe`` and ``1f1b``, and its float32
   twin under ``gpipe`` (float32 products and gradients: bf16 rounding
   alone moves the bf16 runs' tables 0.016 to 0.019 off one process,
   near the gate); (M2)
   ``transformer_moe`` (``train_moe``'s width) on expert x tp
   (1,1,2,1,2), float32 on random tokens and bf16 on counting tokens
   (``axes_layouts``' two runs); (M3) pipe x expert (1,1,1,2,2): the
   reference refuses a 2-stage ``transformer_moe`` (a stage may not hold
   a ``MoEFFN``, whose state it refuses), so the run is the nearest that
   works: ``transformer_moe``'s width with one MoE block (its tables
   over expert) before two dense blocks, the 2 stages, float32 on random
   tokens; (M4) the bench LM on (1,2,2), float32, ``MX_REMAT_STEPS``
   steps without and with ``set_remat("full")``; (M5) M1's model,
   float32, on (2,1,1,2,1) with ``BIGDL_TORCH_FUSED_UPDATE=1``, without
   and with ``BIGDL_TORCH_WIRE_BUCKET_MB`` = ``MX_BUCKET_MB``; (M6)
   LeNet-5 (the
   README's quick start, float32, TF32 off) with ``LBFGS`` on (2,2,1);
   (M7) ``bench.py``'s ``widedeep`` (batch 512, embed 64, hidden (256,
   128), float32) on (1,1,2,1,2), ``MX_TABLE_STEPS`` steps.  One process
   trains each model in each dtype once first (M1's float32 twin's for
   M5, M4's once).  ``CHIP_SMOKE_PLANT=expert_group`` plants a fault in
   the ranks (``mx_plant_expert_group``), which M2's and M3's gates must
   fail.  Gates a rank and
   run: the gathered weights bit-equal on the four ranks; each unit's
   change within ``PS_DELTA_TOL`` of one process's (LeNet-5's and Wide &
   Deep's weights within ``MX_F32_TOL``); the rank's parameter
   elements the plan's; B6 (with the log-sum-exp too) and B7 launches a
   step and B6's shapes exactly ``MX_LAUNCHES``' on the dtype's route;
   the Engine's collectives a step exactly ``MX_COLLECTIVES``' (the
   pipe's hops from its tables, M5's buckets from the plan); the stage
   stack 1/2 a rank; under (1,1,2,2,1) only the head on tp; every MoE
   layer on its experts; M4 with remat and M5 with buckets bit-equal to
   the run without; M7's tables ``device_fraction`` 0.25
   (``memstats.embedding_table_bytes``) and its float32 eval forward
   within ``MX_F32_TOL`` of one process's.  Printed: each run's
   seconds (set-up and the checks after it apart), losses, unit errors
   and collectives a rank, M5's all-reduces a step, M4's peak a rank
   (float32) beside ``axes_layouts``' bf16 one and ``held_peak``; B6
   with the log-sum-exp and B7 at M1's [4, 8, 256, 64] bf16, M2's [16, 4, 256,
   64] float32 and bf16, M1's twin's and M3's stages' [4, 8, 256, 64]
   float32, M4's [8, 4, 512, 64] float32 and M5's [2, 8, 256, 64]
   float32, causal, held to their plain versions and timed beside SDPA
   and the bound.

Then a ``kernels`` line (one entry per kernel and path, with its launches
on that path: B6 on the serving path and per timed LM run, B7 per timed
LM run, B8 per warm continuous decode run (and per batch run beside it), B3 and B4 per timed data-parallel run, B1, B2, B4 and B5 per
timed training run; each also per route; B1, B2, B4 and B5 per timed
accumulation run and B6 and B7 per LM remat run of ``train_longrun``,
with the times ``bn_kernels`` took at the microbatch shapes and
``train_lm`` at the LM step's; B1, B2, B4 and B5 per streamed run of
``train_records`` and B1 and B2 per CLI run, with ``train``'s times; B1,
B2, B4 and B5 per BN-Inception run of ``train_zoo``, with the times
``bn_kernels`` took at BN-Inception's largest shapes; B6 and B7 per ViT
run, B6 per ViT eval, B6 and B7 per CLI ``vit`` run (D = 16, with the
D = 16 ``"tc"`` cases beside them, launched 0 times on that path), B6
per int8 scoring run and B8 per warm int8 decode run of ``zoo_data``,
B6 per scoring window and per publishing trainer, B7 per publishing
trainer and B8 per ``/v1/generate`` run of ``serve_stack``, B6 and B7
per elastic drill (rank 0 and the joiner) of ``elastic_fleet`` with the
shrunk world's case, B6 and B7 per traced LM run of ``observe`` and per
MoE run of ``train_moe``, B6 and B7 per pipelined, ring and Ulysses run
of ``pipe_seq``, B6, B7 and B8 per layout run of ``layouts``, B6 (by
sequence bucket) and B8 (by cache length) per run of ``serve_layouts``
B6 and B7 per pipelined, MoE and ring shape of ``axes_layouts``
(the four ranks' launches together), B1, B2, B4 and B5 over
``interop`` and B6 and B7 per pipe x tp (bf16; float32 with pipe x
expert), expert x tp (float32, bf16), remat and buckets run of
``mixed_layouts``, each with its case's times), the
card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero without that line; so does a machine
without CUDA.
"""

import collections
import contextlib
import copy
import gc
import io
import json
import logging
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

import bigdl_torch.nn as nn
from bigdl_torch import Engine
from bigdl_torch.common import DTypePolicy, set_policy
from bigdl_torch.dataset import (DataSet, LocalArrayDataSet, Sample,
                                 SampleToMiniBatch, Transformer)
from bigdl_torch.dataset import image as img_mod
from bigdl_torch.models import (LeNet5, ResNet, TransformerLM,
                                cached_generate, greedy_generate)
from bigdl_torch.models import decode as dec_mod
from bigdl_torch.models import resnet as resnet_mod
from bigdl_torch.models import run as zoo_run
from bigdl_torch.ops import attention as attn_ops
from bigdl_torch.ops import batchnorm as bn_ops
from bigdl_torch.ops import convbn as cb_ops
from bigdl_torch.ops import decode_attention as dec_ops
from bigdl_torch.optim import (LBFGS, SGD, Adadelta, Adagrad, Adam,
                               Adamax, Evaluator, Loss, MultiStep, Optimizer,
                               Perplexity, Predictor, RMSprop, Top1Accuracy,
                               Top5Accuracy, Trigger)
from bigdl_torch.optim.optimizer import HostCopy, to_host
from bigdl_torch.parallel import (DataParallel, LayoutSharding, MeshLayout,
                                  ShardedDataParallel, TensorParallel,
                                  bucket_count, measure_collective_seconds)
from bigdl_torch.serve import (DecodeEngine, InferenceServer,
                               ReplicaLostError, TopologyRouter, fit_bucket,
                               pad_tail)
from bigdl_torch.serve import continuous as tct
from bigdl_torch.serve import tracefile
from bigdl_torch.tools import model_validator, record_generator, serve_http
from bigdl_torch import interop
from bigdl_torch.parallel import expert as moe_mod
from bigdl_torch.parallel import hops as hops_mod
from bigdl_torch.parallel import mesh_plan
from bigdl_torch.parallel import (GPipeSequential, partition_pipeline,
                                  ring_attention, ulysses_attention)
from bigdl_torch.parallel.schedule import (bubble_fraction, build_schedule,
                                           stack_index)
from bigdl_torch.parallel.wire import bucket_assignment
from bigdl_torch.tools import trace_report
from bigdl_torch.utils import (chaos, crc32c, cuda_build, file_io, flops,
                               memstats, metrics_export, native, profiling,
                               telemetry, timing)
from bigdl_torch.utils.recordio import count_records, write_records
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

SEED = 0
LM = dict(vocab_size=32000, max_len=512, d_model=512, num_heads=8,
          num_layers=8)
SEQ_BUCKETS = (128, 256, 512)
MAX_BATCH = 8
N_REQUESTS = 16

# published peaks of one H100 SXM (dense): HBM bytes/s, and FLOP/s by the
# operands' type (bf16 on the tensor cores, float32 on the CUDA cores)
PEAK_BYTES = 3.35e12
# its streaming multiprocessors: B8's cluster split on the card must be the
# one this count gives
H100_SMS = 132
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
              (2, 4, 200, 200, 128, torch.bfloat16, False),
              # D = 16: the zoo CLI's ViT (4 heads of 16, 64 tokens) and
              # ragged cases on both routes
              (8, 4, 64, 64, 16, torch.bfloat16, False),
              (2, 4, 200, 37, 16, torch.bfloat16, True),
              (2, 4, 37, 200, 16, torch.float32, False))
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
# the rest of data parallelism: every route trains the same TRAIN_STEPS
# from one saved state under deterministic cuDNN and must match the others
# bit for bit (at a world of one every collective is a copy)
FUSED_KNOB = {"BIGDL_TORCH_FUSED_UPDATE": "1"}
DP_BUCKET_MB = 25
DP_ROUTES = (("data_parallel", False, {}),
             ("data_parallel_buckets", False,
              {"BIGDL_TORCH_WIRE_BUCKET_MB": str(DP_BUCKET_MB)}),
             ("zero", True, {}),
             ("zero_fused", True, FUSED_KNOB))

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
    """Every CUDA source with nvcc, and the host library with the host
    compiler beside them (``cuda_build.HOST_SOURCES``)."""
    t0 = time.perf_counter()
    host = {}

    def build_host():
        try:
            cuda_build.build_host()
        except RuntimeError as e:   # raised again below
            host["error"] = e
        host["seconds"] = time.perf_counter() - t0
    thread = threading.Thread(target=build_host)
    thread.start()
    libs = cuda_build.build(cuda_build.SOURCES)
    seconds = time.perf_counter() - t0
    thread.join()
    if "error" in host:
        raise host["error"]
    ptxas = {}
    for name, path in libs.items():
        with open(path[:-3] + ".log") as f:
            ptxas[name] = ptxas_functions(f.read().splitlines())
    emit({"phase": "build", "gpu": gpu_line(), "seconds": seconds,
          "host_sources": list(cuda_build.HOST_SOURCES),
          "host_seconds": host["seconds"], "sources": list(libs),
          "ptxas": ptxas})


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
    shapes += [(8, 8, 512, 512, d) for d in (16, 32, 128)]
    shapes += [(8, 8, 200, 200, d) for d in (16, 32, 128)]
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
    # the split launched is sized from the card's SM count; on the H100
    # it must be the one the H100 SXM's 132 give
    C = dec_ops.splits(S, H, L, dec_ops.sm_count(q.device))
    h100_split = C == dec_ops.splits(S, H, L, H100_SMS)
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
        ok = (routed and repeat and appended and untouched and h100_split
              and bool(
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
            "route": rt, "splits": C, "splits_h100": h100_split,
            "sm_count": dec_ops.sm_count(q.device),
            "max_abs_err": float(err.max()),
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


#: bn_kernels' cases beside a step's shapes, each in float32 and bf16:
#: ragged ones (B5's (37, 19, 70) on ``"mma_sync"``, the BatchNorms'
#: (1000, 130) on ``"scalar"``) and wide ones
BN_EXTRA = {"matmul_stats": [(1000, 64, 64), (37, 19, 70), (300, 130, 2048)],
            "other": [(1000, 3), (1000, 130), (12544, 2048)]}


def phase_bn_kernels(seen, kinds, path, extra=BN_EXTRA):
    """Each of ``kinds`` at every distinct shape the step of ``path`` gave
    it (bf16), plus the ``extra`` cases in float32 and bf16; returns, per
    kernel, the case of its largest call and its device ms per step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
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
            check(routes.get(((37, 19, 70), "bfloat16"), "mma_sync")
                  == "mma_sync", f"B5 ragged bf16 route {routes}")
        else:
            # every step shape on the streaming kernel; a ragged C on the
            # one-element-a-thread one
            routes = {(tuple(c["shape"]), c["dtype"]): c["route"]
                      for c in cases}
            check(all(c["route"] == "vec" for c in cases
                      if c["calls_per_step"]), f"{kind} step routes {routes}")
            check(routes.get(((1000, 130), "bfloat16"), "scalar")
                  == "scalar", f"{kind} ragged bf16 route {routes}")
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
          criterion=None, method=None, on_step=None, strategy=None):
    """``steps`` Optimizer steps on a fresh ``DataSet.array(samples,
    distributed=distributed)`` (seeded: every call visits the same
    batches); returns the loss the driver observed after each step, and
    leaves the Optimizer's counters in ``train.metrics`` and the Optimizer
    in ``train.opt``.  Under the Engine's group the Optimizer trains
    data-parallel (``strategy``, default ``DataParallel``).  The default
    criterion and method are the ResNet path's.  ``on_step(n)``, if
    given, is called as step n starts (at the loop's first trigger check
    for it, once its batch is in hand), and with n = steps + 1 as the
    last step ends (before the Optimizer's wrap-up)."""
    losses, started = {}, set()

    def end(state):
        n = state["neval"]
        if n > 1:
            losses[n - 1] = state["loss"]
        if on_step is not None and n <= steps + 1 and n not in started:
            started.add(n)
            on_step(n)
        return n > steps

    opt = Optimizer(model, DataSet.array(samples, distributed=distributed,
                                         seed=SEED),
                    criterion or nn.CrossEntropyCriterion(),
                    batch_size=batch, device=device, strategy=strategy)
    opt.set_optim_method(method or SGD(0.1))
    opt.set_end_when(Trigger(end, "steps"))
    opt.optimize()
    train.metrics, train.opt = opt.metrics, opt
    return [losses[k] for k in sorted(losses)]


@contextlib.contextmanager
def knobs(env):
    """The environment variables of ``env`` set inside the block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def prefetch_depth(depth):
    """``BIGDL_TORCH_PREFETCH_DEPTH`` set to ``depth`` inside the block."""
    return knobs({"BIGDL_TORCH_PREFETCH_DEPTH": str(depth)})


def record_inputs(model):
    """A forward pre-hook keeping a copy of every input batch the model
    is given; returns (the list, the hook handle)."""
    seen = []
    handle = model.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].detach().clone()))
    return seen, handle


class StepMarks:
    """``train``'s ``on_step``: a CUDA event as each step starts and as
    the last one ends, so :meth:`ms` is the steps' device-clock time
    alone, without the Optimizer's set-up (the broadcast from rank 0) or
    its wrap-up."""

    def __init__(self):
        self.events = {}

    def __call__(self, n):
        self.events[n] = torch.cuda.Event(enable_timing=True)
        self.events[n].record()

    def ms(self):
        """ms a step from step 1's start to the last step's end."""
        torch.cuda.synchronize()
        last = max(self.events)
        return self.events[1].elapsed_time(self.events[last]) / (last - 1)


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
    peak = phase_train.peak = torch.cuda.max_memory_allocated()
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
    return kernel_rows(reps, launched, "train", routes), first[0], step_ms


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
    # (no single-device loss when the phase runs alone)
    diff = (None if single_first_loss is None
            else abs(first[0] - single_first_loss))
    check(diff is None or diff <= UNFUSED_ATOL, f"data-parallel vs "
          f"single-device first loss: {first[0]} vs {single_first_loss}")

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
    route_runs = dp_routes(model, samples)
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
          "routes": route_runs, **bit, **prof})
    return kernel_rows(reps, launched, "dp_train", routes)


def expected_collectives(steps, params, zero, bucket_mb=0, bn_sites=None,
                          min_size=2 ** 14, world=1):
    """The collectives ``steps`` steps over ``params`` issue: the
    gradients' all-reduce (one per float32 bucket of ``bucket_mb``), or
    under ZeRO one reduce-scatter and one all-gather per dtype of the
    sliced parameters a step (the whole final state is gathered only when
    ``final_opt_state`` is read); sync-BN's all-reduces at ``bn_sites``
    sites a step where given."""
    grads = 1
    if not zero and bucket_mb > 0:
        grads = bucket_count(params, torch.float32, bucket_mb)
    out = {"all_reduce": {"grads": grads * steps}, "reduce_scatter": {},
           "all_gather": {}}
    if bn_sites is not None:
        out["all_reduce"].update(bn_stats=bn_sites * steps,
                                 bn_grad_stats=bn_sites * steps)
    if zero:
        axes = ShardedDataParallel(min_size).param_axes(params, world)
        dtypes = {p.dtype for p, a in zip(params, axes) if a is not None}
        out["reduce_scatter"] = {"grads": steps}
        out["all_gather"] = {"params": len(dtypes) * steps}
    return out


def dp_routes(model, samples):
    """``TRAIN_STEPS`` of SGD with momentum from the model's present state
    in each of ``DP_ROUTES`` (the per-leaf ``DataParallel``, its buckets
    launched from the backward, ZeRO, ZeRO with the fused update), under
    deterministic cuDNN: losses and every parameter and buffer bit-equal
    across the routes, B3, B4 and B5 launches and routes exactly
    ``DP_STEP_LAUNCHES`` a step, the collectives exactly as predicted.
    Each route reports its step time (:class:`StepMarks`: the steps
    alone), a profiled run's device idle share, its peak memory, the
    method state's bytes and the collective probe (0.0 at a world of
    one)."""
    reset = Reset(model)
    with deterministic_cudnn():
        # cuDNN picks its deterministic algorithms on the first call: not
        # in the first route's time
        train(reset.model(), samples, 1, TRAIN_BATCH, distributed=True)
    out, first = {}, None
    for name, zero, env in DP_ROUTES:
        m = reset.model()
        with knobs(env), deterministic_cudnn():
            strategy = ShardedDataParallel() if zero else DataParallel()

            def run(steps, on_step=None):
                return train(m, samples, steps, TRAIN_BATCH,
                             distributed=True, strategy=strategy,
                             method=SGD(0.1, momentum=0.9), on_step=on_step)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            Engine.clear_counts()
            marks = StepMarks()
            losses = run(TRAIN_STEPS, marks)
            step_ms = marks.ms()
            launched, coll = counts(), Engine.collectives()
            peak = torch.cuda.max_memory_allocated()
            state = snapshot(m)
            bucket_mb = float(env.get("BIGDL_TORCH_WIRE_BUCKET_MB", 0))
            want = expected_collectives(
                TRAIN_STEPS, list(m.parameters()), zero, bucket_mb,
                bn_sites=DP_STEP_ALL_REDUCES["bn_stats"])
            check(launched == {k: v * TRAIN_STEPS
                               for k, v in DP_STEP_LAUNCHES.items()},
                  f"{name}: launches over {TRAIN_STEPS} steps {launched}")
            check_step_routes(launched, f"dp_train route {name}")
            check(coll == want, f"{name}: collectives {coll}, want {want}")
            probe = measure_collective_seconds(list(m.parameters()),
                                               torch.float32, bucket_mb)
            prof = profile_step(lambda mark: run(1 + PROFILE_STEPS, mark),
                                distributed=True)
        if first is None:
            first = (losses, state)
        check(losses == first[0] and bit_equal(state, first[1]),
              f"route {name} differs from {DP_ROUTES[0][0]}: {losses} vs "
              f"{first[0]}")
        out[name] = {"env": env, "step_ms": step_ms,
                     "losses": losses, "bit_equal_to_first": True,
                     "device_idle_share": prof.get("device_idle_share"),
                     "steady": prof.get("steady"),
                     "max_memory_allocated": peak,
                     "opt_state_bytes": train.opt.opt_state_bytes,
                     "collectives": coll, "collective_s": probe,
                     "grad_all_reduces_per_step":
                     want["all_reduce"]["grads"] // TRAIN_STEPS}
    return out


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


# the two-rank routes: ZeRO's plan at the small ResNet's sizes (its leaves
# are all under the default 2^14 elements) and buckets of a few leaves each
DP_ZERO_MIN_SIZE = 256
DP_SMALL_BUCKET_MB = 0.002
DP_CHILD_ROUTES = (("data_parallel", False, {}),
                   ("zero", True, {}),
                   ("zero_fused", True, FUSED_KNOB),
                   ("data_parallel_buckets", False,
                    {"BIGDL_TORCH_WIRE_BUCKET_MB": str(DP_SMALL_BUCKET_MB)}))
# sharded inference: rows and batch that do not divide by the world
INFER_ROWS = 13
INFER_BATCH = 5
INFER_TOL = 1e-5


def dp_method():
    return SGD(0.1, momentum=0.9)


def dp_strategy(zero):
    return (ShardedDataParallel(min_size=DP_ZERO_MIN_SIZE) if zero
            else DataParallel())


def infer_samples():
    rs = np.random.default_rng(SEED + 4)
    x = rs.standard_normal((INFER_ROWS, 32, 32, 3), dtype=np.float32)
    y = rs.integers(0, 10, INFER_ROWS).astype(np.int32)
    return x, [Sample(x[i], y[i]) for i in range(INFER_ROWS)]


def infer(model):
    """The small ResNet's predictions over ``infer_samples`` as an array
    and as Samples, and its evaluation: under a group, sharded."""
    x, samples = infer_samples()
    pred = Predictor(model, INFER_BATCH)
    res = Evaluator(model).test(samples, [Top1Accuracy(), Loss(
        nn.CrossEntropyCriterion())], INFER_BATCH)
    return (pred.predict(x), pred.predict(samples),
            [[m.name, vars(r)] for m, r in res])


def dp_child(out_dir):
    """One rank of ``dp_two_process``: the rank, world and rendezvous come
    from the ``BIGDL_TORCH_*`` env contract.  Trains every route of
    ``DP_CHILD_ROUTES`` from the same weights, times the collective probe
    and runs the sharded inference."""
    float32_exact()
    Engine.init(device="cuda:0", backend="gloo")
    rank = Engine.rank()
    runs = {}
    for name, zero, env in DP_CHILD_ROUTES:
        model = small_resnet().build("cuda",
                                     torch.Generator().manual_seed(SEED))
        zero_counts()
        Engine.clear_counts()
        with knobs(env):
            losses = train(model, small_samples(), DP_STEPS, DP_LOCAL_BATCH,
                           distributed=True, strategy=dp_strategy(zero),
                           method=dp_method())
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   os.path.join(out_dir, f"{name}.rank{rank}.pt"))
        runs[name] = {"losses": losses, "launches": counts(),
                      "b5_route_launches": b5_routes(),
                      "collectives": Engine.collectives(),
                      "opt_state_bytes": train.opt.opt_state_bytes}
    params = list(model.parameters())
    probe = {"per_leaf": measure_collective_seconds(params, torch.float32, 0),
             "buckets": measure_collective_seconds(params, torch.float32,
                                                   DP_SMALL_BUCKET_MB)}
    model = small_resnet().build("cuda", torch.Generator().manual_seed(SEED))
    pred_x, pred_s, evaluation = infer(model)
    np.save(os.path.join(out_dir, f"predict.rank{rank}.npy"),
            np.stack([pred_x, pred_s]))
    emit({"rank": rank, "world": Engine.world(), "runs": runs,
          "collective_s": probe, "evaluate": evaluation,
          "slice_route": Engine.slice_route()})
    Engine.reset()
    return 0


def spawn_ranks(flag, tmp, timeout, n=2, meanwhile=None):
    """``n`` ranks of this script (``flag`` ``tmp``) on the one card in a
    gloo group meeting through ``tmp``; returns (their last JSON lines,
    wall seconds).  ``meanwhile``, where given, is called here while the
    ranks start and run.  Every process is killed and reaped before it
    returns."""
    env = {**os.environ,
           "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
           "BIGDL_TORCH_COORDINATOR": f"file://{tmp}/store",
           "BIGDL_TORCH_NUM_PROCESSES": str(n)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, tmp],
        env={**env, "BIGDL_TORCH_PROCESS_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]
    try:
        if meanwhile is not None:
            meanwhile()
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        check(p.returncode == 0, f"rank failed ({p.returncode}):\n"
              f"{out[-2000:]}\n{err[-4000:]}")
    ranks = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    check([r["rank"] for r in ranks] == list(range(n))
          and all(r["world"] == n for r in ranks), f"ranks {ranks}")
    return ranks, wall


def plan_state_bytes(model, zero, n_slots, min_size=2 ** 14, world=2):
    """A rank's float32 method-state bytes under the plan: ``n_slots``
    slots of every leaf, a sliced leaf's 1/world of it."""
    shapes = [tuple(p.shape) for p in model.parameters()]
    axes = (ShardedDataParallel(min_size=min_size).param_axes(shapes, world)
            if zero else [None] * len(shapes))
    return n_slots * 4 * sum(math.prod(s) // (world if a is not None else 1)
                             for s, a in zip(shapes, axes))


def phase_dp_two_process():
    float32_exact()
    ref = small_resnet().build("cuda", torch.Generator().manual_seed(SEED))
    ref_losses = train(ref, small_samples(), DP_STEPS, 2 * DP_LOCAL_BATCH,
                       method=dp_method())
    ref_state = {k: v.cpu() for k, v in ref.state_dict().items()}
    fresh = small_resnet().build("cuda", torch.Generator().manual_seed(SEED))
    one_x, one_s, one_eval = infer(fresh)
    with tempfile.TemporaryDirectory() as tmp:
        ranks, wall = spawn_ranks("--dp-child", tmp, DP_CHILD_TIMEOUT)
        states = {name: [torch.load(os.path.join(tmp, f"{name}.rank{i}.pt"))
                         for i in range(2)]
                  for name, _, _ in DP_CHILD_ROUTES}
        preds = [np.load(os.path.join(tmp, f"predict.rank{i}.npy"))
                 for i in range(2)]
    report = {}
    for name, zero, env in DP_CHILD_ROUTES:
        rr = [r["runs"][name] for r in ranks]
        st = states[name]
        for r in rr:
            check(all(r["launches"][k] > 0 for k in
                      ("bn_stats", "bn_grad_stats", "matmul_stats")),
                  f"{name}: a rank skipped a kernel: {r['launches']}")
            b5 = r["b5_route_launches"]
            check(b5["f32"] == r["launches"]["matmul_stats"]
                  and b5["tc"] == b5["mma_sync"] == 0,
                  f"{name}: float32 B5 routes {b5}")
        check(rr[0]["losses"] == rr[1]["losses"]
              and rr[0]["collectives"] == rr[1]["collectives"]
              and all(torch.equal(st[0][k], st[1][k]) for k in st[0]),
              f"{name}: the two ranks diverged")
        loss_err = max(abs(a - b) for a, b in zip(rr[0]["losses"],
                                                 ref_losses))
        state_err = max(rel_err(st[0][k], v)[1] for k, v in ref_state.items())
        check(len(ref_losses) == DP_STEPS and loss_err <= DP_F32_ATOL
              and state_err <= DP_F32_ATOL,
              f"{name}: two ranks vs one process: losses {rr[0]['losses']} "
              f"vs {ref_losses}, params/stats {state_err}")
        want_bytes = plan_state_bytes(ref, zero, 1, DP_ZERO_MIN_SIZE)
        check(all(r["opt_state_bytes"] == want_bytes for r in rr),
              f"{name}: state bytes {[r['opt_state_bytes'] for r in rr]}, "
              f"plan {want_bytes}")
        # sync-BN's all-reduces as the per-leaf route's, the rest exact
        want = expected_collectives(
            DP_STEPS, list(ref.parameters()), zero,
            float(env.get("BIGDL_TORCH_WIRE_BUCKET_MB", 0)),
            min_size=DP_ZERO_MIN_SIZE, world=2)
        got = rr[0]["collectives"]
        bn = {k: v for k, v in ranks[0]["runs"]["data_parallel"][
            "collectives"]["all_reduce"].items() if k.startswith("bn_")}
        want["all_reduce"].update(bn)
        check(bn and got == want,
              f"{name}: collectives {got}, want {want}")
        report[name] = {"losses": rr[0]["losses"], "max_loss_diff": loss_err,
                        "max_state_rel_err": state_err,
                        "opt_state_bytes": rr[0]["opt_state_bytes"],
                        "collectives": got,
                        "launches": rr[0]["launches"],
                        "b5_route_launches": rr[0]["b5_route_launches"]}
    check(np.array_equal(preds[0], preds[1])
          and ranks[0]["evaluate"] == ranks[1]["evaluate"],
          "the ranks' sharded inference differs")
    infer_err = max(rel_err(torch.from_numpy(p), torch.from_numpy(one))[1]
                    for p, one in zip(preds[0], (one_x, one_s)))
    check(preds[0].shape[1] == INFER_ROWS and infer_err <= INFER_TOL,
          f"sharded predictions vs one process: {infer_err}")
    for (name, got), (m, want) in zip(ranks[0]["evaluate"], one_eval):
        check(name == m and got["count"] == want["count"] == INFER_ROWS
              and got.get("correct") == want.get("correct")
              and abs(got.get("loss", 0) - want.get("loss", 0))
              <= INFER_TOL * max(1, abs(want.get("loss", 0))),
              f"sharded evaluation {name}: {got} vs {want}")
    emit({"phase": "dp_two_process", "gpu": gpu_line(), "backend": "gloo",
          "slice_route": ranks[0]["slice_route"],
          "world": 2, "batch_per_process": DP_LOCAL_BATCH,
          "steps": DP_STEPS, "wall_s": wall,
          "losses_one_process": ref_losses, "tol": DP_F32_ATOL,
          "zero_min_size": DP_ZERO_MIN_SIZE,
          "bucket_mb": DP_SMALL_BUCKET_MB, "routes": report,
          "collective_s": [r["collective_s"] for r in ranks],
          "sharded_inference": {"rows": INFER_ROWS, "batch": INFER_BATCH,
                                "max_rel_err": infer_err,
                                "tol": INFER_TOL,
                                "evaluate": ranks[0]["evaluate"]}})


# -- 10b. zero_full_width ------------------------------------------------------

# two gloo ranks on the card: ResNet-50 at the resnet50_bf16 width, Adam;
# the routes run A, B, B, A (the first run also loads cuDNN's algorithms).
# DataParallel against ZeRO at two ranks: both sum the same two partial
# gradients for each element (a + b commutes) and run the same elementwise
# update on each element, so losses, parameters, buffers and the whole
# Adam state must be bit-equal (across routes, repeats and ranks)
ZERO_STEPS = 2
ZERO_BATCH = 32
ZERO_ORDER = ("data_parallel", "zero", "zero", "data_parallel")
ZERO_TIMEOUT = 600


def host_tree(tree):
    """A state tree with every tensor copied to the host and every numpy
    leaf (Adam's int32 ``t``) made a tensor, so ``torch.load`` reads it
    back with its default ``weights_only``."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host_tree(v) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.tensor(np.asarray(tree))
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def state_leaves(tree):
    """A state tree's leaves as they are (tensors keep their dtype)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in state_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in state_leaves(v)]
    return [tree]


def trees_bit_equal(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    return len(la) == len(lb) and all(
        isinstance(y, torch.Tensor) and torch.equal(x, y)
        if isinstance(x, torch.Tensor) else bool(np.array_equal(x, y))
        for x, y in zip(la, lb))


def zero_child(out_dir):
    """One rank of ``zero_full_width``: ResNet-50 as ``train`` builds it,
    ``ZERO_STEPS`` of Adam at ``ZERO_BATCH`` images a rank, under
    ``DataParallel`` and ``ShardedDataParallel`` in ``ZERO_ORDER``.  Each
    run's steps are timed alone (:class:`StepMarks`), then the whole final
    Adam state is read (under ZeRO its first read all-gathers the slices,
    timed on its own).  The first run of each route saves its parameters,
    buffers and whole Adam state; a repeat must equal it bit for bit."""
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    Engine.init(device="cuda:0", backend="gloo")
    rank = Engine.rank()
    samples = synthetic_imagenet(2 * ZERO_BATCH * ZERO_STEPS, SEED)
    runs = {name: [] for name in ZERO_ORDER}
    first = {}
    for name in ZERO_ORDER:
        model = resnet50(fuse=True)
        strategy = (ShardedDataParallel() if name == "zero"
                    else DataParallel())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Engine.clear_counts()
        marks = StepMarks()
        losses = train(model, samples, ZERO_STEPS, ZERO_BATCH,
                       distributed=True, strategy=strategy,
                       method=Adam(1e-3), on_step=marks)
        step_ms = marks.ms()
        coll = Engine.collectives()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        whole = train.opt.final_opt_state
        end.record()
        torch.cuda.synchronize()
        gather_wall_ms = (time.perf_counter() - t0) * 1e3
        final_gathers = (Engine.collectives()["all_gather"].get(
            "opt_state", 0) - coll["all_gather"].get("opt_state", 0))
        saved = {"model": host_tree(model.state_dict()),
                 "opt_state": host_tree(whole)}
        if name not in first:
            first[name] = saved
            torch.save(saved, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
        runs[name].append({
            "losses": losses, "step_ms": step_ms,
            "final_gather_ms": start.elapsed_time(end),
            "final_gather_wall_ms": gather_wall_ms,
            "final_gathers": final_gathers,
            "equal_to_first_run": trees_bit_equal(saved, first[name]),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "opt_state_bytes": train.opt.opt_state_bytes,
            "collectives": coll})
        del model, strategy, whole, saved
        train.opt = None
        torch.cuda.empty_cache()
    emit({"rank": rank, "world": Engine.world(), "runs": runs,
          "slice_route": Engine.slice_route()})
    Engine.reset()
    return 0


def phase_zero_full_width():
    """Two gloo ranks on the card train ResNet-50 (resnet50_bf16 width)
    with Adam under DataParallel and under ZeRO: losses, parameters,
    buffers and the whole final Adam state bit-equal across the routes,
    the repeats and the ranks; each rank's Adam state exactly the plan's
    (half of every sliced leaf's two slots, all of the replicated ones');
    the collectives as predicted, the final state gathered once under
    ZeRO and never under DataParallel."""
    with tempfile.TemporaryDirectory() as tmp:
        ranks, wall = spawn_ranks("--zero-child", tmp, ZERO_TIMEOUT)
        saved = {(name, i): torch.load(os.path.join(
            tmp, f"{name}.rank{i}.pt")) for name in ("data_parallel", "zero")
            for i in range(2)}
    model = ResNet(50, class_num=1000, dataset="imagenet")
    nn.fuse_conv_bn(model)
    model.build("meta")
    params = list(model.parameters())
    dp, zero = (ranks[0]["runs"][k][0] for k in ("data_parallel", "zero"))
    for r in ranks:
        for name, one in (("data_parallel", dp), ("zero", zero)):
            check(all(run["losses"] == one["losses"]
                      and run["equal_to_first_run"]
                      for run in r["runs"][name]),
                  f"the ranks or the repeats diverged: {ranks}")
    check(len(dp["losses"]) == ZERO_STEPS
          and all(map(math.isfinite, dp["losses"]))
          and zero["losses"] == dp["losses"],
          f"ZeRO vs DataParallel losses {zero['losses']} vs {dp['losses']}")
    base = saved[("data_parallel", 0)]
    n_leaves = len(state_leaves(base["opt_state"]))
    for key, got in saved.items():
        check(trees_bit_equal(got["model"], base["model"])
              and trees_bit_equal(got["opt_state"], base["opt_state"]),
              f"{key}: parameters, buffers or the whole Adam state differ "
              "from rank 0's DataParallel run")
    check(n_leaves == 2 * len(params) + 1,
          f"the whole Adam state has {n_leaves} leaves")
    want = {"data_parallel": plan_state_bytes(model, False, 2),
            "zero": plan_state_bytes(model, True, 2)}
    for r in ranks:
        got = {k: {run["opt_state_bytes"] for run in r["runs"][k]}
               for k in want}
        check(got == {k: {v} for k, v in want.items()},
              f"rank {r['rank']}: state bytes {got}, plan {want}")
        for k in want:
            bn = {b: v for b, v in r["runs"]["data_parallel"][0][
                "collectives"]["all_reduce"].items() if b.startswith("bn_")}
            expect = expected_collectives(ZERO_STEPS, params, k == "zero",
                                          world=2)
            expect["all_reduce"].update(bn)
            check(bn and all(run["collectives"] == expect
                             and run["final_gathers"] == (k == "zero")
                             for run in r["runs"][k]),
                  f"rank {r['rank']} {k}: collectives "
                  f"{[run['collectives'] for run in r['runs'][k]]}, "
                  f"final gathers "
                  f"{[run['final_gathers'] for run in r['runs'][k]]}, "
                  f"want {expect}")

    def each(key):
        return {k: [run[key] for run in ranks[0]["runs"][k]] for k in want}
    emit({"phase": "zero_full_width", "gpu": gpu_line(),
          "model": "ResNet-50", "backend": "gloo",
          "slice_route": ranks[0]["slice_route"],
          "world": 2, "batch_per_process": ZERO_BATCH,
          "steps": ZERO_STEPS, "method": "Adam", "wall_s": wall,
          "losses": {"data_parallel": dp["losses"], "zero": zero["losses"]},
          "bit_equal": "losses, parameters, buffers, whole Adam state",
          "opt_state_bytes": want,
          "saving_bytes": want["data_parallel"] - want["zero"],
          "order": ZERO_ORDER, "step_ms": each("step_ms"),
          "final_gather_ms": each("final_gather_ms"),
          "final_gather_wall_ms": each("final_gather_wall_ms"),
          "max_memory_allocated": [
              {k: [run["max_memory_allocated"] for run in r["runs"][k]]
               for k in want} for r in ranks],
          "collectives": {k: ranks[0]["runs"][k][0]["collectives"]
                          for k in want}})


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
    for d in (16, 32, 128):
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
    attn_ops.flash_attention.lse_launches = 0


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
    peak = phase_train_lm.peak = torch.cuda.max_memory_allocated()
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


# ---------------------------------------------------------------------------
# train_validate: validation, checkpoints and resume, the methods, LeNet-5
# ---------------------------------------------------------------------------

# ResNet-50 at resnet50_bf16: 2 epochs of 3 batches, 512 held-out images
TV_BATCHES = 3
TV_EPOCHS = 2
TV_HELD_OUT = 512
# MultiStep drops the lr tenfold from the 5th iteration (evalCounter 4)
TV_MILESTONES = [4]
# the LM: 2 batches of 16 x 512 an epoch, 4 steps; validation and a
# snapshot after every 2nd finished iteration, over 2 batches of 4 x 512
TV_LM_STEPS = 4
TV_LM_VAL_BATCH = 4
TV_LM_VAL_ROWS = 8
# validation results vs Evaluator on the same weights: the loss summed in
# another order over the same float32 rows (the counts must be equal)
TV_EVAL_RTOL = 1e-6
# every ported method's update on the card vs on the CPU from the same
# parameters and gradients, 3 steps: relative to each parameter's largest
# magnitude (elementwise float32 arithmetic; the card may fuse a multiply
# and an add or round a square root differently)
TV_METHOD_RTOL = 1e-4
# the README flow (SKILL.md's calibration: Adam(3e-3) x 8 epochs)
TV_LENET_EPOCHS = 8
TV_LENET_LOSS = 1.0
TV_LENET_TOP1 = 0.95


#: a ResNet-50 step's launches by kernel and route: STEP_LAUNCHES, each
#: on its kernel's step route
STEP_ROUTE_LAUNCHES = {
    kind: {rt: (n if rt == STEP_ROUTES[kind] else 0)
           for rt in TRAIN_KERNELS[kind][0].route_launches}
    for kind, n in STEP_LAUNCHES.items()}


def every_done(n):
    """Once after every n-th finished iteration (the driver's neval is one
    ahead of the iterations done when triggers read it, and an epoch's end
    that follows such an iteration asks again)."""
    box = {"last": None}

    def fn(state):
        done = state["neval"] - 1
        if done % n or done == box["last"]:
            return False
        box["last"] = done
        return True
    return Trigger(fn, f"everyDone({n})")


def synthetic_mnist(n, seed):
    """tests/test_e2e_lenet.py's separable digits: class k has a bright
    k-th block."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 0.1, size=(n, 28, 28)).astype(np.float32)
    labels = rng.integers(0, 10, size=n)
    for i, label in enumerate(labels):
        r, c = divmod(int(label), 5)
        images[i, 4 + r * 10: 12 + r * 10, 2 + c * 5: 7 + c * 5] += 1.5
    return [Sample.from_ndarray(images[i], np.int32(labels[i]))
            for i in range(n)]


def result_fields(results):
    """[(method name, {field: value})] of validation results."""
    return [(m.name, dict(vars(r))) for m, r in results]


def resume_rule(resumed, first, second):
    """The resumed run's numbers against two uninterrupted runs': bit-equal
    where those two were bit-equal to each other, else inside their
    spread.  Returns (ok, rule, spread)."""
    if first == second:
        return resumed == first, "bit-equal", 0.0
    spread = max(abs(a - b) for a, b in zip(first, second))
    ok = all(min(a, b) - spread <= r <= max(a, b) + spread
             for r, a, b in zip(resumed, first, second))
    return ok, "within the spread of two runs", spread


def flat_results(fields):
    return [float(v) for _, f in fields for k, v in sorted(f.items())]


class Watch:
    """Instruments one Optimizer: launches per training step, what each
    validation launched and left behind, each checkpoint write."""

    def __init__(self, opt, kernel_counts, zero, routes=None):
        self.opt, self._counts, self._zero = opt, kernel_counts, zero
        self._routes = routes
        self.steps, self.validations, self.writes = [], [], []
        # each step's launches by kernel and route, where ``routes`` is given
        self.step_routes = []
        # each step's host time, synchronized at its end
        self.step_ms = []
        self.on_write = None
        step, validate, write = (opt._step, opt._run_validation,
                                 opt._write_checkpoint)

        def stepped(*a):
            self._zero()
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.steps.append(self._counts())
            if self._routes is not None:
                self.step_routes.append(self._routes())
            return out

        def validated():
            model = opt.model
            before = [b.detach().clone() for b in model.buffers()]
            self._zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = validate()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            same = all(torch.equal(a, b)
                       for a, b in zip(before, model.buffers()))
            self.validations.append({
                "ms": ms, "launches": self._counts(),
                "state_bit_equal": same, "train_mode": model.training,
                "results": result_fields(out)})
            return out

        def written(state, opt_state, rng, preempt=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            write(state, opt_state, rng, preempt)
            ms = (time.perf_counter() - t0) * 1e3
            n = state["neval"] - 1
            path = opt.checkpoint_path
            mp = os.path.join(path, f"model.{n}")
            op = os.path.join(path, f"optimMethod.{n}")
            t0 = time.perf_counter()
            file_io.verify(mp)
            file_io.verify(op)
            blob = file_io.load(mp)
            file_io.load(op)
            load_ms = (time.perf_counter() - t0) * 1e3
            live = to_reference_tree(opt.model)
            equal = all(np.array_equal(a, b) for a, b in zip(
                tree_leaves((blob["params"], blob["state"])),
                tree_leaves(live)))
            rec = {"neval": n, "write_ms": ms, "verify_load_ms": load_ms,
                   "bytes": os.path.getsize(mp) + os.path.getsize(op),
                   "model_bytes": os.path.getsize(mp),
                   "bit_equal_live": equal}
            self.writes.append(rec)
            if self.on_write is not None:
                self.on_write(mp, op, n)

        opt._step, opt._run_validation = stepped, validated
        opt._write_checkpoint = written


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def resnet_run(samples, held, ckpt, resume=None, keep=None):
    """ResNet-50 (fused, bf16) through one Optimizer with validation every
    epoch and a snapshot every epoch (keep_last=1): fresh from the seed, or
    resumed from ``resume`` with the dataset's permutation advanced past
    epoch 1.  Returns (model, watch, losses by iteration, resume ms)."""
    model = resnet50(fuse=True)
    ds = DataSet.array(samples, seed=SEED)
    if resume is not None:
        ds.shuffle()            # the permutation epoch 1 drew
    opt = Optimizer(model, ds, nn.CrossEntropyCriterion(),
                    batch_size=TRAIN_BATCH)
    opt.set_optim_method(SGD(0.1, momentum=0.9, weight_decay=1e-4,
                             learning_rate_schedule=MultiStep(
                                 TV_MILESTONES, 0.1)))
    opt.set_validation(Trigger.every_epoch(), held,
                       [Top1Accuracy(), Top5Accuracy(),
                        Loss(nn.CrossEntropyCriterion())], TRAIN_BATCH)
    opt.set_checkpoint(ckpt, Trigger.every_epoch(), keep_last=1)
    watch = Watch(opt, counts, zero_counts, route_counts)
    if keep is not None:
        watch.on_write = keep
    losses = {}

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["epoch"] > TV_EPOCHS
    resume_ms = None
    if resume is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.resume_from(*resume)
        torch.cuda.synchronize()
        resume_ms = (time.perf_counter() - t0) * 1e3
    opt.set_end_when(Trigger(end, "epochs")).optimize()
    return model, opt, watch, losses, resume_ms


def tv_resnet(train_step_ms, root):
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    samples = synthetic_imagenet(TRAIN_BATCH * TV_BATCHES, SEED + 7)
    held = synthetic_imagenet(TV_HELD_OUT, SEED + 8)
    side = os.path.join(root, "epoch1")
    os.makedirs(side)
    kept = []

    def keep_first(mp, op, n):
        if not kept:
            for p in (mp, op):
                shutil.copy(p, side)
            kept.append((os.path.join(side, os.path.basename(mp)),
                         os.path.join(side, os.path.basename(op))))

    runs = []
    for i in range(2):
        ckpt = os.path.join(root, f"resnet{i}")
        model, opt, watch, losses, _ = resnet_run(
            samples, held, ckpt, keep=keep_first if i == 0 else None)
        left = sorted(os.listdir(ckpt))
        if i == 0:
            final = {m.name: dict(vars(r))
                     for m, r in opt.last_validation}
            ev = Evaluator(model).test(held, [
                Top1Accuracy(), Top5Accuracy(),
                Loss(nn.CrossEntropyCriterion())], TRAIN_BATCH)
            evaluator = {m.name: dict(vars(r)) for m, r in ev}
        runs.append((losses, watch, left))
        del model, opt
        torch.cuda.empty_cache()
    (losses, watch, left), (losses2, watch2, _) = runs

    steps = TV_BATCHES * TV_EPOCHS
    check(len(watch.steps) == steps and all(
        c == STEP_LAUNCHES for c in watch.steps),
        f"launches per step {watch.steps}")
    check(all(r == STEP_ROUTE_LAUNCHES for r in watch.step_routes)
          and len(watch.step_routes) == steps,
          f"launches per step by route {watch.step_routes}")
    check(len(watch.validations) == TV_EPOCHS and all(
        v["launches"] == dict.fromkeys(STEP_LAUNCHES, 0)
        for v in watch.validations),
        f"validation launches {[v['launches'] for v in watch.validations]}")
    check(all(v["state_bit_equal"] and v["train_mode"]
              for v in watch.validations),
          f"validation left the model changed: {watch.validations}")
    for name, f in evaluator.items():
        g = final[name]
        check(g["count"] == f["count"] == TV_HELD_OUT, f"{name} {g} {f}")
        if "correct" in f:
            check(g["correct"] == f["correct"], f"{name}: {g} vs {f}")
        else:
            check(abs(g["loss"] - f["loss"]) <= TV_EVAL_RTOL * abs(f["loss"]),
                  f"{name}: {g} vs {f}")
    check(len(watch.writes) == TV_EPOCHS and all(
        w["bit_equal_live"] for w in watch.writes),
        f"snapshots {watch.writes}")
    check(left == [f"model.{steps}", f"optimMethod.{steps}"],
          f"retention left {left}")
    check(kept, "the epoch-1 pair was not kept")

    # resume from the epoch-1 pair: epoch 2 again
    model, opt, rwatch, rlosses, resume_ms = resnet_run(
        samples, held, os.path.join(root, "resumed"), resume=kept[0])
    del model, opt
    torch.cuda.empty_cache()
    ep2 = list(range(TV_BATCHES + 1, steps + 1))
    first = [losses[k] for k in ep2]
    second = [losses2[k] for k in ep2]
    resumed = [rlosses.get(k) for k in ep2]
    ok, rule, spread = resume_rule(resumed, first, second)
    check(ok, f"resumed epoch-2 losses {resumed} vs {first} / {second}")
    val = [flat_results(w.validations[-1]["results"])
           for w in (rwatch, watch, watch2)]
    vok, vrule, vspread = resume_rule(*val)
    check(vok, f"resumed epoch-2 validation {val}")
    check(all(c == STEP_LAUNCHES for c in rwatch.steps)
          and all(r == STEP_ROUTE_LAUNCHES for r in rwatch.step_routes)
          and len(rwatch.steps) == TV_BATCHES,
          f"resumed launches per step {rwatch.step_routes}")
    vms = [v["ms"] for v in watch.validations]
    return {
        "batch": TRAIN_BATCH, "epochs": TV_EPOCHS,
        "batches_per_epoch": TV_BATCHES, "held_out": TV_HELD_OUT,
        "step_ms": watch.step_ms, "step_ms_median_epoch2": float(
            np.median(watch.step_ms[TV_BATCHES:])),
        "train_phase_step_ms": train_step_ms,
        "launches_per_step": watch.steps[0],
        "route_launches_per_step": watch.step_routes[0],
        "validation_launches": watch.validations[0]["launches"],
        "validation_ms": vms,
        "validation_images_per_s": [TV_HELD_OUT / (t / 1e3) for t in vms],
        "validation_results": final, "evaluator_results": evaluator,
        "snapshots": watch.writes, "retention_left": left,
        "losses": [losses[k] for k in sorted(losses)],
        "losses_second_run": [losses2[k] for k in sorted(losses2)],
        "resumed_losses": resumed, "resume_rule": rule,
        "resume_spread": spread, "resumed_validation": val[0],
        "validation_rule": vrule, "validation_spread": vspread,
        "resume_ms": resume_ms}


def lm_run(samples, held, ckpt, resume=None):
    """The bench-width LM, Adam(1e-3) with clipping at 1.0, validation and
    a snapshot after every 2nd finished iteration, TV_LM_STEPS steps."""
    model = TransformerLM(**LM).build(
        "cuda", torch.Generator().manual_seed(SEED))
    ds = DataSet.array(samples, seed=SEED)
    if resume is not None:
        ds.shuffle()
    opt = Optimizer(model, ds, nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(), size_average=True), batch_size=LM_BATCH)
    opt.set_optim_method(Adam(1e-3)).set_gradient_clipping_by_l2_norm(1.0)
    opt.set_validation(every_done(2), held, [
        Loss(nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                         size_average=True)),
        Perplexity()], TV_LM_VAL_BATCH)
    opt.set_checkpoint(ckpt, every_done(2))

    def lm_counts():
        return {"flash": attn_ops.flash_attention.launches,
                "flash_lse": attn_ops.flash_attention.lse_launches,
                "flash_tc": attn_ops.flash_attention.route_launches["tc"],
                "flash_bwd": attn_ops.flash_attention_bwd.launches,
                "flash_bwd_tc":
                attn_ops.flash_attention_bwd.route_launches["tc"]}

    def zero():
        zero_flash()
        attn_ops.flash_attention.lse_launches = 0
    watch = Watch(opt, lm_counts, zero)
    losses = {}

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > TV_LM_STEPS
    if resume is not None:
        opt.resume_from(*resume)
    opt.set_end_when(Trigger(end, "steps")).optimize()
    del model, opt
    torch.cuda.empty_cache()
    return watch, losses


def tv_lm(root):
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    T, V = LM["max_len"], LM["vocab_size"]
    samples = lm_samples(LM_BATCH * 2, T, V, SEED + 9)
    held = lm_samples(TV_LM_VAL_ROWS, T, V, SEED + 10)
    L = LM["num_layers"]
    runs = []
    for i in range(2):
        runs.append(lm_run(samples, held, os.path.join(root, f"lm{i}")))
    (watch, losses), (_, losses2) = runs
    per_step = {"flash": L, "flash_lse": L, "flash_tc": L,
                "flash_bwd": 2 * L, "flash_bwd_tc": 2 * L}
    batches = TV_LM_VAL_ROWS // TV_LM_VAL_BATCH
    per_val = {"flash": L * batches, "flash_lse": 0,
               "flash_tc": L * batches, "flash_bwd": 0, "flash_bwd_tc": 0}
    check(len(watch.steps) == TV_LM_STEPS and all(
        c == per_step for c in watch.steps), f"LM launches {watch.steps}")
    check(len(watch.validations) == TV_LM_STEPS // 2 and all(
        v["launches"] == per_val and v["train_mode"]
        for v in watch.validations),
        f"LM validation launches {[v['launches'] for v in watch.validations]}")
    check(all(w["bit_equal_live"] for w in watch.writes)
          and len(watch.writes) == TV_LM_STEPS // 2,
          f"LM snapshots {watch.writes}")
    pair = (os.path.join(root, "lm0", "model.2"),
            os.path.join(root, "lm0", "optimMethod.2"))
    rwatch, rlosses = lm_run(samples, held, os.path.join(root, "lmr"),
                             resume=pair)
    tail = list(range(3, TV_LM_STEPS + 1))
    resumed = [rlosses.get(k) for k in tail]
    first, second = [losses[k] for k in tail], [losses2[k] for k in tail]
    ok, rule, spread = resume_rule(resumed, first, second)
    check(ok, f"resumed LM losses {resumed} vs {first} / {second}")
    check(all(c == per_step for c in rwatch.steps),
          f"resumed LM launches {rwatch.steps}")
    vms = [v["ms"] / batches for v in watch.validations]
    return {"batch": LM_BATCH, "seq": T, "steps": TV_LM_STEPS,
            "step_ms": watch.step_ms, "launches_per_step": watch.steps[0],
            "validation_launches": watch.validations[0]["launches"],
            "validation_ms_per_batch": vms,
            "validation_batch": [TV_LM_VAL_BATCH, T, V],
            "validation_results": watch.validations[-1]["results"],
            "snapshots": watch.writes,
            "losses": [losses[k] for k in sorted(losses)],
            "losses_second_run": [losses2[k] for k in sorted(losses2)],
            "resumed_losses": resumed, "resume_rule": rule,
            "resume_spread": spread}


def tv_generator(root):
    """The float32 small LM with dropout 0.1: 2 steps, a snapshot, resume,
    2 more; the resumed losses bit-equal to the uninterrupted run's."""
    set_policy(DTypePolicy())
    torch.backends.cuda.matmul.allow_tf32 = False
    samples = lm_samples(16, LM_SMALL["max_len"], LM_SMALL["vocab_size"],
                         SEED + 11)

    def run(ckpt, resume=None):
        m = TransformerLM(**LM_SMALL, dropout=0.1).build(
            "cuda", torch.Generator().manual_seed(SEED))
        ds = DataSet.array(samples, seed=SEED)
        if resume is not None:
            ds.shuffle()
        opt = Optimizer(m, ds, nn.TimeDistributedCriterion(
            nn.ClassNLLCriterion(), size_average=True), batch_size=8)
        opt.set_optim_method(Adam(1e-3))
        opt.set_checkpoint(ckpt, every_done(2))
        if resume is not None:
            opt.resume_from(*resume)
        losses = {}

        def end(state):
            if state["neval"] > 1:
                losses[state["neval"] - 1] = state["loss"]
            return state["neval"] > 4
        opt.set_end_when(Trigger(end, "steps")).optimize()
        return losses
    full = run(os.path.join(root, "g0"))
    pair = (os.path.join(root, "g0", "model.2"),
            os.path.join(root, "g0", "optimMethod.2"))
    saved = file_io.load(pair[1])["torch_rng_state"]
    resumed = run(os.path.join(root, "g1"), pair)
    want, got = [full[3], full[4]], [resumed.get(3), resumed.get(4)]
    check(got == want and saved is not None and saved["device"] == "cuda",
          f"dropout LM resumed {got} vs {want}, generator {saved}")
    return {"losses": [full[k] for k in sorted(full)], "resumed": got,
            "generator_state_bytes": int(np.asarray(saved["state"]).size)}


def tv_methods():
    """Every ported method on the float32 small LM (TF32 off, no wire): 3
    steps on the card and on the CPU, losses within F32_TRAIN_ATOL; and
    the method's update run on the card from the CPU run's start with the
    CPU run's gradients, step for step, parameters within TV_METHOD_RTOL
    of the CPU's.  The trained parameters' card-vs-CPU difference is
    reported, not held: the normalizing methods (Adagrad, Adamax,
    RMSprop) turn the 1e-7 summation differences of gradient entries near
    zero into lr-sized differences of those entries."""
    float32_exact()
    samples = lm_samples(24, LM_SMALL["max_len"], LM_SMALL["vocab_size"],
                         SEED + 12)
    methods = {
        "SGD_nesterov": lambda: SGD(0.05, momentum=0.9, dampening=0.0,
                                    nesterov=True, weight_decay=1e-4),
        "Adam": lambda: Adam(1e-3), "Adagrad": lambda: Adagrad(1e-2),
        "Adadelta": lambda: Adadelta(), "Adamax": lambda: Adamax(2e-3),
        "RMSprop": lambda: RMSprop(1e-3)}

    def crit():
        return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                           size_average=True)

    def rel_diff(got, want, skip=()):
        """Per parameter, max |got - want| over its largest magnitude; the
        largest of those, and the parameter's name (names ending in one of
        ``skip`` left out)."""
        worst = (0.0, "")
        for (n, a), b in zip(got, want):
            if n.endswith(tuple(skip)):
                continue
            d = float((a.detach().cpu() - b.detach().cpu()).abs().max())
            r = d / max(float(b.detach().abs().max()), 1e-30)
            worst = max(worst, (r, n))
        return worst
    out = {}
    for name, make in methods.items():
        cpu = TransformerLM(**LM_SMALL).build(
            "cpu", torch.Generator().manual_seed(SEED))
        gpu = copy.deepcopy(cpu).to("cuda")
        start = [p.detach().to("cuda", copy=True) for p in cpu.parameters()]
        card = train(gpu, samples, 3, 8, criterion=crit(), method=make())
        method, seen = make(), []
        update = method.update

        def recording(grads, params, state, lr, update=update, seen=seen):
            seen.append(([g.detach().clone() for g in grads], lr))
            return update(grads, params, state, lr)
        method.update = recording
        host = train(cpu, samples, 3, 8, device="cpu", criterion=crit(),
                     method=method)
        again = make()
        state = again.init_state(start)
        for grads, lr in seen:
            state = again.update([g.to("cuda") for g in grads], start,
                                 state, lr)
        names = [n for n, _ in cpu.named_parameters()]
        same, same_at = rel_diff(zip(names, start), cpu.parameters())
        trained, trained_at = rel_diff(gpu.named_parameters(),
                                       cpu.parameters())
        # without the key bias, whose gradient is zero in exact arithmetic
        no_bk, no_bk_at = rel_diff(gpu.named_parameters(), cpu.parameters(),
                                   skip=(".bk",))
        loss_diff = max(abs(a - b) for a, b in zip(card, host))
        check(len(seen) == 3 and same <= TV_METHOD_RTOL,
              f"{name}: the update on the card vs the CPU {same} at "
              f"{same_at}")
        check(loss_diff <= F32_TRAIN_ATOL and all(map(math.isfinite, card)),
              f"{name}: losses card {card} vs CPU {host}")
        out[name] = {"same_gradients_max_rel_diff": same,
                     "trained_max_rel_diff": trained,
                     "trained_worst_param": trained_at,
                     "trained_max_rel_diff_without_bk": no_bk,
                     "trained_worst_param_without_bk": no_bk_at,
                     "losses_card": card, "losses_cpu": host,
                     "max_loss_diff": loss_diff}
    return out


def tv_lenet(root):
    """The README's quick start on the port: LeNet-5 on synthetic MNIST,
    Adam(3e-3), 8 epochs, Top1 validation and a snapshot every epoch."""
    set_policy(DTypePolicy())
    model = LeNet5(10)
    opt = (Optimizer(model, DataSet.array(synthetic_mnist(512, SEED)),
                     nn.ClassNLLCriterion(), batch_size=64)
           .set_optim_method(Adam(3e-3))
           .set_validation(Trigger.every_epoch(),
                           synthetic_mnist(256, SEED + 1), [Top1Accuracy()])
           .set_checkpoint(os.path.join(root, "lenet"), Trigger.every_epoch())
           .set_end_when(Trigger.max_epoch(TV_LENET_EPOCHS)))
    zero_counts()
    zero_flash()
    t0 = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t0
    loss = opt.optim_method.hyper["loss"]
    top1 = opt.optim_method.hyper["Top1Accuracy"]
    kernels = {**counts(), "flash": attn_ops.flash_attention.launches}
    check(loss < TV_LENET_LOSS and top1 >= TV_LENET_TOP1,
          f"LeNet-5: loss {loss}, Top1 {top1}")
    check(not any(kernels.values()), f"LeNet-5 launched {kernels}")
    check(next(model.parameters()).device.type == "cuda",
          "LeNet-5 did not train on the card")
    n = len(file_io.checkpoint_lineage(os.path.join(root, "lenet")))
    check(n == TV_LENET_EPOCHS, f"LeNet-5 snapshots {n}")
    return {"final_loss": loss, "top1": top1, "epochs": TV_LENET_EPOCHS,
            "wall_s": wall, "snapshots": n, "repo_kernel_launches": kernels}


def phase_train_validate(train_step_ms):
    """Validation, checkpoints and resume on the card: ResNet-50 and the
    LM at full width, the Dropout generator carried across, every ported
    method card vs CPU, and the README's LeNet-5 flow."""
    t0 = time.perf_counter()
    crc32c.native()                      # a failed build raises here
    route = crc32c.route()
    check(route.startswith("compiled"), f"CRC32C route {route}")
    root = tempfile.mkdtemp(prefix="bigdl-torch-ckpt-")
    old = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    # deterministic convolutions, so two uninterrupted runs can be
    # bit-equal and the resumed one held to them bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        resnet = tv_resnet(train_step_ms, root)
        lm = tv_lm(root)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = old
        gen = tv_generator(root)
        methods = tv_methods()
        lenet = tv_lenet(root)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = old
        shutil.rmtree(root, ignore_errors=True)
        set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    emit({"phase": "train_validate", "gpu": gpu_line(), "crc32c_route": route,
          "cudnn_deterministic": True, "resnet50": resnet, "lm": lm,
          "dropout_generator": gen, "methods": methods, "lenet5": lenet,
          "wall_s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# train_longrun: accumulation, remat, EMA, summaries, the retry loop, the
# supervisor, preemption, asynchronous and remote snapshots, LBFGS, scales
# ---------------------------------------------------------------------------

# ResNet-50 at resnet50_bf16 with set_gradient_accumulation(4): batch 256
# in 4 microbatches of 64, 3 steps
LR_ACCUM = 4
LR_STEPS = 3
LR_MICRO = TRAIN_BATCH // LR_ACCUM
# launches per step: each microbatch launches what a train step does
ACCUM_STEP_LAUNCHES = {k: LR_ACCUM * v for k, v in STEP_LAUNCHES.items()}
# launches per step under each remat policy (batch 256): the recompute of
# "conv_out" launches the 20 unfused BatchNorms' B1 again and takes B5's
# outputs back; "full" launches B1 and B5 again; the backward (B2, B4)
# runs once
REMAT_STEP_LAUNCHES = {
    "none": STEP_LAUNCHES,
    "conv_out": {**STEP_LAUNCHES, "bn_forward": 40},
    "full": {**STEP_LAUNCHES, "bn_forward": 40, "matmul_stats": 66}}
# the LM under set_remat("full"): B6 with the log-sum-exp once in the
# forward and once in the recompute, B7 as without remat
LM_REMAT_STEP = {"flash": 16, "flash_lse": 16, "flash_bwd": 16}
LM_LONGRUN_STEPS = 4
EMA_DECAY = 0.999
# the EMA shadow vs the formula on host copies of the parameters, relative
# to each parameter's largest magnitude: the same float32 operations, the
# card possibly fusing a multiply and an add
EMA_RTOL = 1e-6
# the retry, supervisor and preemption runs: ResNet-50 at batch 64, 2
# batches an epoch in a fixed order, a snapshot after every 2nd finished
# iteration, 7 iterations
RETRY_BATCH = 64
RETRY_ITERS = 7
RETRY_IMAGES = 2 * RETRY_BATCH
# the async-vs-sync runs: batch 256, a snapshot every iteration
ASYNC_ITERS = 3
SUPERVISE_STEP_S = 2.0
SUPERVISE_DATA_S = 2.0


class FixedOrder(LocalArrayDataSet):
    """Records in their given order every epoch: a run that restarts an
    epoch after recovery or resume sees the batches an uninterrupted run
    sees."""

    def shuffle(self):
        pass


@contextlib.contextmanager
def deterministic_cudnn():
    old = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = old


class Reset:
    """One model and its starting state on the card: ``model()`` puts the
    state back and returns it (cheaper than building ResNet-50 again)."""

    def __init__(self, model):
        self._model = model
        self._start = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}

    def model(self):
        self._model.load_state_dict(self._start)
        self._model.train()
        for p in self._model.parameters():
            p.grad = None
        return self._model


def snapshot(model):
    return [t.detach().clone() for t in
            list(model.parameters()) + list(model.buffers())]


def bit_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def lr_opt(model, samples, batch, fixed=True, method=None, lm=False):
    ds = FixedOrder(samples) if fixed else DataSet.array(samples, seed=SEED)
    crit = (nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                        size_average=True)
            if lm else nn.CrossEntropyCriterion())
    opt = Optimizer(model, ds, crit, batch_size=batch)
    opt.set_optim_method(method or SGD(0.1, momentum=0.9))
    return opt


def run_iters(opt, iters, on_start=None):
    """Drive ``opt`` until ``iters`` iterations are done; returns (losses
    by iteration, ms from each iteration's start to the next one's: the
    step and its boundary).  ``on_start(n)`` runs as iteration n
    starts."""
    losses, t = {}, {}

    def end(state):
        n = state["neval"]
        if n > 1:
            losses[n - 1] = state["loss"]
        if n not in t:
            t[n] = time.perf_counter()
            if on_start is not None and n <= iters:
                on_start(n)
        return n > iters
    opt.set_end_when(Trigger(end, "iters")).optimize()
    ms = [(t[n + 1] - t[n]) * 1e3 for n in sorted(t) if n + 1 in t]
    return losses, ms


def peak_run(run):
    """``run()`` with the allocator's peak reset first: (its result, the
    peak bytes allocated, that peak less what was allocated at the start:
    the run's own share, apart from what earlier phases still hold)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    peak = torch.cuda.max_memory_allocated()
    return out, peak, peak - start


def computing_ms(opt):
    """The Optimizer's "computing time average" in ms: each step's host
    time from its batch in hand to its loss read (the card synchronised
    by that read)."""
    total, n = opt.metrics.get("computing time average")
    return total / max(n, 1) * 1e3


def batch_tensors(samples, n):
    x = torch.from_numpy(np.stack([s.feature for s in samples[:n]]))
    y = torch.from_numpy(np.stack([s.label for s in samples[:n]]))
    return x.cuda(), y.cuda()


class Capture(SGD):
    """Keeps the step's final gradients and updates nothing."""

    def update(self, grads, params, state, lr):
        self.grads = [g.detach().clone() for g in grads]
        return state


def lr_accumulation(reset, samples):
    """(a) set_gradient_accumulation(4) at batch 256: one step's gradients
    against four hand-run microbatches, the microbatch shapes through
    bn_kernels, 3 timed steps."""
    from bigdl_torch.parallel.wire import wire_cast
    from bigdl_torch.common import get_policy
    model = reset.model()
    x, y = batch_tensors(samples, TRAIN_BATCH)
    crit = nn.CrossEntropyCriterion()
    # four microbatch backward passes by hand, summed in order, over 4
    for m in model.parameters():
        m.grad = None
    seen, handles = record_shapes(model)
    zero_counts()
    for i in range(LR_ACCUM):
        sl = slice(i * LR_MICRO, (i + 1) * LR_MICRO)
        crit(model(x[sl]), y[sl]).backward()
    hand_counts = counts()
    for h in handles:
        h.remove()
    hand = wire_cast([p.grad / LR_ACCUM for p in model.parameters()],
                     get_policy().wire_dtype)
    hand_buffers = [b.detach().clone() for b in model.buffers()]
    # the Optimizer's step from the same state
    model = reset.model()
    opt = lr_opt(model, samples, TRAIN_BATCH)
    opt.set_gradient_accumulation(LR_ACCUM)
    cap = Capture()
    opt.set_optim_method(cap)
    params = list(model.parameters())
    opt._step(params, {}, x, y, 0.0, None)
    torch.cuda.synchronize()
    grads_equal = bit_equal(cap.grads, hand)
    buffers_equal = bit_equal(list(model.buffers()), hand_buffers)
    check(grads_equal and buffers_equal,
          f"accumulated step vs hand-run microbatches: gradients equal "
          f"{grads_equal}, buffers equal {buffers_equal}")
    check(hand_counts == ACCUM_STEP_LAUNCHES,
          f"hand-run microbatch launches {hand_counts}")
    for kind, n in STEP_SHAPES.items():
        check(len(seen[kind]) == n and sum(seen[kind].values())
              == ACCUM_STEP_LAUNCHES[kind],
              f"microbatch {kind} shapes {dict(seen[kind])}")
    # the last stage at microbatch 64: R = 64·7·7 = 3136, 24.5 row tiles
    ragged = [sh for sh in seen["matmul_stats"] if sh[0] % cb_ops.ROW_TILE]
    check(any(sh[0] == LR_MICRO * 49 for sh in ragged),
          f"no ragged B5 row count: {sorted(seen['matmul_stats'])}")
    reps = phase_bn_kernels(seen, STEP_SHAPES, "train_longrun")
    # the timed steps
    model = reset.model()
    opt = lr_opt(model, samples, TRAIN_BATCH)
    opt.set_gradient_accumulation(LR_ACCUM)
    zero_counts()
    (losses, ms), peak, own = peak_run(lambda: run_iters(opt, LR_STEPS))
    launched, routes = counts(), route_counts()
    want = {k: v * LR_STEPS for k, v in ACCUM_STEP_LAUNCHES.items()}
    check(launched == want, f"accumulation launches {launched} != {want}")
    check_step_routes(launched, "accumulation steps")
    check(len(losses) == LR_STEPS and all(map(math.isfinite,
                                              losses.values())),
          f"accumulation losses {losses}")
    return reps, launched, routes, {
        "accum_steps": LR_ACCUM, "microbatch": LR_MICRO,
        "steps": LR_STEPS, "losses": [losses[k] for k in sorted(losses)],
        "iteration_ms": ms, "computing_ms": computing_ms(opt),
        "max_memory_allocated": peak, "run_peak_over_start": own,
        "launches_per_step": {k: v // LR_STEPS for k, v in launched.items()},
        "grads_bit_equal_hand_run": grads_equal,
        "buffers_equal_hand_run": buffers_equal,
        "microbatch_b5_shapes": sorted(seen["matmul_stats"]),
        "ragged_b5_shapes": sorted(ragged)}


def lr_remat(reset, samples):
    """(b) no remat, "conv_out" and "full", 3 steps each at batch 256 from
    one state: losses, parameters and buffers bit-equal, the launches
    stated in PERF.md, the peak memory of each."""
    out, finals = {}, {}
    for policy in ("none", "conv_out", "full"):
        model = reset.model()
        opt = lr_opt(model, samples, TRAIN_BATCH)
        opt.set_remat(None if policy == "none" else policy)
        zero_counts()
        (losses, ms), peak, own = peak_run(lambda: run_iters(opt, LR_STEPS))
        launched = counts()
        want = {k: v * LR_STEPS for k, v in
                REMAT_STEP_LAUNCHES[policy].items()}
        check(launched == want, f"remat {policy}: launches {launched} != "
              f"{want}")
        check_step_routes(launched, f"remat {policy}")
        finals[policy] = ([losses[k] for k in sorted(losses)],
                          snapshot(model))
        out[policy] = {"losses": finals[policy][0], "iteration_ms": ms,
                       "computing_ms": computing_ms(opt),
                       "max_memory_allocated": peak,
                       "run_peak_over_start": own,
                       "launches_per_step": REMAT_STEP_LAUNCHES[policy]}
    for policy in ("conv_out", "full"):
        same = (finals[policy][0] == finals["none"][0]
                and bit_equal(finals[policy][1], finals["none"][1]))
        out[policy]["bit_equal_none"] = same
        check(same, f"remat {policy} vs none: losses "
              f"{finals[policy][0]} vs {finals['none'][0]}")
    check(out["full"]["run_peak_over_start"]
          < out["none"]["run_peak_over_start"],
          f"remat full peak {out['full']['run_peak_over_start']} not "
          f"below none's {out['none']['run_peak_over_start']}")
    return out


def lm_longrun_counts():
    return {"flash": attn_ops.flash_attention.launches,
            "flash_lse": attn_ops.flash_attention.lse_launches,
            "flash_bwd": attn_ops.flash_attention_bwd.launches}


def lr_lm(root):
    """(c) The bench-width LM, EMA(Adam, 0.999), a TrainSummary, 4 steps
    with set_remat("full") and without: losses bit-equal, 16 B6 with the
    log-sum-exp and 16 B7 a step, the shadow equal to the formula, the
    summary's Loss equal to the observed losses; and the float32 dropout
    LM's gradients under remat bit-equal to those without."""
    from bigdl_torch.optim import EMA
    from bigdl_torch.visualization import TrainSummary
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    T, V = LM["max_len"], LM["vocab_size"]
    samples = lm_samples(LM_BATCH * 2, T, V, SEED + 13)
    runs = {}
    for policy in (None, "full"):
        model = TransformerLM(**LM).build(
            "cuda", torch.Generator().manual_seed(SEED))
        method = EMA(Adam(1e-3), EMA_DECAY)
        host = [[p.detach().float().cpu().numpy().copy()
                 for p in model.parameters()]]
        update = method.update

        def recording(grads, params, state, lr, update=update, host=host):
            out = update(grads, params, state, lr)
            host.append([p.detach().float().cpu().numpy().copy()
                         for p in params])
            return out
        method.update = recording
        opt = lr_opt(model, samples, LM_BATCH, method=method, lm=True)
        opt.set_remat(policy)
        summary = TrainSummary(os.path.join(root, "tb"), str(policy))
        opt.set_train_summary(summary)
        zero_flash()
        attn_ops.flash_attention.lse_launches = 0
        (losses, ms), peak, own = peak_run(
            lambda: run_iters(opt, LM_LONGRUN_STEPS))
        launched = lm_longrun_counts()
        lm_routes = (dict(attn_ops.flash_attention.route_launches),
                     dict(attn_ops.flash_attention_bwd.route_launches))
        read = summary.read_scalar("Loss")
        summary.close()
        # the shadow by the formula, on the host copies in float32
        d = np.float32(EMA_DECAY)
        shadow = [a.copy() for a in host[0]]
        for step in host[1:]:
            shadow = [d * s + np.float32(1 - EMA_DECAY) * p
                      for s, p in zip(shadow, step)]
        got = method.ema_params(opt.final_opt_state)
        ema_err = max(float(np.abs(g.float().cpu().numpy() - s).max())
                      / max(float(np.abs(s).max()), 1e-30)
                      for g, s in zip(got, shadow))
        lossv = [losses[k] for k in sorted(losses)]
        summary_ok = ([(s, v) for s, v, _ in read]
                      == [(k, float(np.float32(losses[k])))
                          for k in sorted(losses)])
        runs[policy] = lossv
        key = "remat_full" if policy else "no_remat"
        runs[key] = {"losses": lossv, "iteration_ms": ms,
                     "computing_ms": computing_ms(opt),
                     "max_memory_allocated": peak,
                     "run_peak_over_start": own,
                     "launches_per_step": {k: v / LM_LONGRUN_STEPS
                                           for k, v in launched.items()},
                     "ema_max_rel_err": ema_err,
                     "summary_loss_equal": summary_ok}
        check(ema_err <= EMA_RTOL, f"EMA shadow vs formula: {ema_err}")
        check(summary_ok, f"summary Loss {read} vs losses {losses}")
        if policy == "full":
            want = {k: v * LM_LONGRUN_STEPS for k, v in LM_REMAT_STEP.items()}
            check(launched == want, f"LM remat launches {launched} != {want}")
            check(only_route(attn_ops.flash_attention, "tc", want["flash"])
                  and only_route(attn_ops.flash_attention_bwd, "tc",
                                 want["flash_bwd"]),
                  f"LM remat routes {lm_routes}")
            remat_launches = (launched, lm_routes)
        del model, opt, method, host
        torch.cuda.empty_cache()
    check(runs["full"] == runs[None],
          f"LM remat losses {runs['full']} vs {runs[None]}")
    # the float32 dropout LM: one step's gradients with and without remat
    set_policy(DTypePolicy())
    torch.backends.cuda.matmul.allow_tf32 = False
    small = lm_samples(8, LM_SMALL["max_len"], LM_SMALL["vocab_size"],
                       SEED + 14)
    x, y = (torch.from_numpy(np.stack([getattr(s, a) for s in small])).cuda()
            for a in ("feature", "label"))
    grads = {}
    for policy in (None, "full"):
        m = TransformerLM(**LM_SMALL, dropout=0.1).build(
            "cuda", torch.Generator().manual_seed(SEED))
        opt = lr_opt(m, small, 8, lm=True)
        cap = Capture()
        opt.set_optim_method(cap).set_remat(policy)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        opt._step(list(m.parameters()), {}, x, y, 0.0, gen)
        grads[policy] = cap.grads
    drop_equal = bit_equal(grads[None], grads["full"])
    check(drop_equal, "float32 dropout LM: gradients under remat differ")
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    return {"ema_decay": EMA_DECAY, "steps": LM_LONGRUN_STEPS,
            "no_remat": runs["no_remat"], "remat_full": runs["remat_full"],
            "train_lm_max_memory_allocated": getattr(phase_train_lm, "peak",
                                                     None),
            "losses_bit_equal": True,
            "dropout_f32_grads_bit_equal": drop_equal}, remat_launches


def recording_recovery(opt):
    """Wrap ``opt._recover_from_checkpoint``: each call's ms, the error it
    recovers from, the pinned bytes of the stager and the host caching
    allocator after it."""
    rec = []
    orig = opt._recover_from_checkpoint

    def recover():
        err = sys.exc_info()[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig()
        torch.cuda.synchronize()
        stats = (torch.cuda.host_memory_stats()
                 if hasattr(torch.cuda, "host_memory_stats") else {})
        rec.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "error": type(err).__name__,
                    "stager_pinned_bytes": (opt._stager.pinned_bytes()
                                            if opt._stager else 0),
                    "host_reserved_bytes": stats.get(
                        "reserved_bytes.current")})
    opt._recover_from_checkpoint = recover
    return rec


def lr_retry(reset, samples, root):
    """(d) The retry loop, the supervisor and preemption on ResNet-50 at
    batch 64: every recovered or resumed run ends bit-equal to an
    uninterrupted one."""
    from bigdl_torch.optim import TrainingPreempted
    from bigdl_torch.utils import chaos

    def run(tag, spec=None, supervise=None, env=None, on_start=None):
        model = reset.model()
        opt = lr_opt(model, samples, RETRY_BATCH)
        ckpt = os.path.join(root, tag)
        opt.set_checkpoint(ckpt, every_done(2))
        if supervise:
            opt.set_supervision(**supervise, poll_interval=0.05)
        rec = recording_recovery(opt)
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            with chaos.scoped(spec or ""):
                losses, _ = run_iters(opt, RETRY_ITERS, on_start)
        finally:
            for k, v in old.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        return ([losses[k] for k in sorted(losses)], snapshot(model), rec,
                opt, ckpt)

    base_losses, base_final, _, _, _ = run("base")
    out = {"uninterrupted_losses": base_losses}
    cases = {"step_stall_fail": "step.stall=fail@5",
             "step_loss_nan": "step.loss_nan=nan@5",
             "before_first_snapshot": "step.loss_nan=nan@1"}
    for name, spec in cases.items():
        losses, final, rec, opt, _ = run(name, spec)
        same = losses == base_losses and bit_equal(final, base_final)
        out[name] = {"recoveries": rec, "bit_equal_uninterrupted": same}
        check(len(rec) == 1 and same, f"retry {name}: {rec}, losses "
              f"{losses} vs {base_losses}")
    check(out["step_loss_nan"]["recoveries"][0]["error"]
          == "NonFiniteLossError", f"loss_nan recovery {out}")
    # the failure at iteration 1: the in-place update was undone, the
    # starting weights put back bit for bit
    model = reset.model()
    start = snapshot(model)
    opt = lr_opt(model, samples, RETRY_BATCH)
    opt.set_checkpoint(os.path.join(root, "blob"), every_done(2))
    seen = {}
    restore = opt._restore_blob

    def restoring(blob):
        seen["updated"] = snapshot(model)
        restore(blob)
        seen["restored"] = snapshot(model)
    opt._restore_blob = restoring
    with chaos.scoped("step.loss_nan=nan@1"):
        run_iters(opt, 1)
    restored = bit_equal(seen.get("restored", []), start)
    check(restored and not bit_equal(seen["updated"], start),
          "a failure before the first snapshot did not restore the start")
    out["before_first_snapshot"]["starting_weights_restored"] = restored
    # exhaustion raises the original error
    try:
        run("exhausted", "step.stall=fail*100@1",
            env={"BIGDL_TORCH_RETRY_TIMES": "2"})
        exhausted = None
    except chaos.ChaosFault as e:
        exhausted = str(e)
    check(exhausted and "invocation 3" in exhausted,
          f"exhaustion raised {exhausted}")
    out["exhaustion_error"] = exhausted
    # 3 retries: the pinned ring does not grow
    _, final, rec, _, _ = run("pinned", "step.stall=fail@3,5,7")
    pinned = [r["stager_pinned_bytes"] for r in rec]
    check(len(rec) == 3 and pinned[0] == pinned[2] > 0,
          f"pinned bytes after retries {rec}")
    out["pinned_retries"] = rec
    # the supervisor: a step stall, and a stall in the prefetch worker
    losses, final, rec, opt, ckpt = run(
        "stall", "step.stall=stall*60@5",
        supervise={"step": SUPERVISE_STEP_S})
    reports = sorted(f for f in os.listdir(ckpt)
                     if f.startswith("crash_report") and f.endswith(".json"))
    report = json.load(open(os.path.join(ckpt, reports[0]))) if reports \
        else {}
    same = losses == base_losses and bit_equal(final, base_final)
    check(len(rec) == 1 and rec[0]["error"] == "StallError" and same
          and report.get("phase") == "step",
          f"step stall: {rec}, reports {reports}, same {same}")
    out["supervisor_step"] = {"recoveries": rec, "report": reports[0],
                              "report_platform": report.get("platform"),
                              "bit_equal_uninterrupted": same}
    losses, final, rec, opt, ckpt = run(
        "data_stall", "data.stall=stall*60@6",
        supervise={"data": SUPERVISE_DATA_S})
    same = losses == base_losses and bit_equal(final, base_final)
    check(len(rec) == 1 and rec[0]["error"] == "StallError" and same,
          f"prefetch worker stall: {rec}, same {same}")
    out["supervisor_data"] = {"recoveries": rec,
                              "bit_equal_uninterrupted": same}
    # preemption: SIGTERM as iteration 4 starts, then resume
    model = reset.model()
    opt = lr_opt(model, samples, RETRY_BATCH)
    ckpt = os.path.join(root, "preempt")
    opt.set_checkpoint(ckpt, every_done(100))

    def sigterm(n):
        if n == 4:
            os.kill(os.getpid(), signal.SIGTERM)
    try:
        run_iters(opt, RETRY_ITERS, sigterm)
        preempted = None
    except TrainingPreempted as e:
        preempted = str(e)
    latest = file_io.latest_checkpoint(ckpt)
    check(preempted and latest and latest[2] == 4,
          f"preemption: {preempted}, snapshot {latest}")
    model = reset.model()
    opt = lr_opt(model, samples, RETRY_BATCH)
    opt.resume_from(*latest[:2])
    losses, _ = run_iters(opt, RETRY_ITERS)
    tail = [losses[k] for k in sorted(losses) if k > 4]
    same = tail == base_losses[4:] and bit_equal(snapshot(model),
                                                 base_final)
    check(same, f"resumed after preemption {tail} vs {base_losses[4:]}")
    out["preemption"] = {"error": preempted, "snapshot": latest[2],
                         "resumed_bit_equal_uninterrupted": same}
    return out


class MemStore:
    """An in-process object store with ``file_io``'s filesystem interface,
    registered for a scheme of its own (the card's machine has no
    fsspec)."""

    def __init__(self):
        self.blobs, self.writes = {}, 0

    def write_bytes(self, path, data):
        self.writes += 1
        self.blobs[path] = bytes(data)

    def read_bytes(self, path):
        return self.blobs[path]

    def exists(self, path):
        return path in self.blobs

    def isdir(self, path):
        return any(k.startswith(path.rstrip("/") + "/") for k in self.blobs)

    def listdir(self, path):
        pre = path.rstrip("/") + "/"
        return sorted({k[len(pre):].split("/")[0] for k in self.blobs
                       if k.startswith(pre)})

    def makedirs(self, path):
        pass

    def rename(self, src, dst):
        self.blobs[dst] = self.blobs.pop(src)

    def remove(self, path):
        del self.blobs[path]


def lr_checkpoints(reset, samples, root):
    """(e) Asynchronous against synchronous snapshots of ResNet-50 at batch
    256, one every iteration; a registered store behind the retry layer."""
    from bigdl_torch.utils import chaos
    out = {}
    for mode in ("sync", "async"):
        model = reset.model()
        opt = lr_opt(model, samples, TRAIN_BATCH)
        opt.set_checkpoint(os.path.join(root, mode),
                           Trigger.several_iteration(1),
                           async_write=(mode == "async"))
        losses, ms = run_iters(opt, ASYNC_ITERS)
        out[mode] = {"iteration_ms": ms, "computing_ms": computing_ms(opt),
                     "losses": [losses[k] for k in sorted(losses)]}
    names = sorted(os.listdir(os.path.join(root, "sync")))
    equal = names == sorted(os.listdir(os.path.join(root, "async")))
    for n in names:
        a = file_io.load(os.path.join(root, "sync", n))
        b = file_io.load(os.path.join(root, "async", n))
        equal = equal and all(np.array_equal(x, y) for x, y in zip(
            tree_leaves(a), tree_leaves(b))) and \
            len(tree_leaves(a)) == len(tree_leaves(b))
    check(equal and len(names) == 2 * ASYNC_ITERS,
          f"async snapshots vs sync: {names}")
    out["async_bit_equal_sync"] = equal
    out["pairs"] = len(names) // 2
    # the remote store: FailN(2) on fs.remote, retried, written, verified
    store = MemStore()
    file_io.register_filesystem("bigdlmem", store)
    model = reset.model()
    opt = lr_opt(model, samples, RETRY_BATCH)
    opt.set_checkpoint("bigdlmem://run", Trigger.several_iteration(1))
    with chaos.scoped("fs.remote=fail*2@1"):
        run_iters(opt, 1)
        fails = chaos.counts()["fs.remote"]
    mp, op, n = file_io.latest_checkpoint("bigdlmem://run")
    file_io.verify(mp)
    file_io.verify(op)
    blob = file_io.load(mp)
    live = to_reference_tree(model)
    remote_ok = n == 1 and all(np.array_equal(a, b) for a, b in zip(
        tree_leaves((blob["params"], blob["state"])), tree_leaves(live)))
    check(remote_ok and fails > 2, f"remote pair: {n}, fs.remote calls "
          f"{fails}")
    out["remote"] = {"fs_remote_calls": fails, "store_writes": store.writes,
                     "pair_bytes": sum(len(v) for v in store.blobs.values()),
                     "verified_equal_live": remote_ok}
    return out


def lr_lbfgs_and_scales(reset, samples):
    """(f) LeNet-5's LBFGS update on the card against the CPU's on the same
    gradients; ResNet-50 with the stem's scales at 0."""
    from bigdl_torch.optim import LBFGS
    float32_exact()
    digits = synthetic_mnist(48, SEED + 15)
    cpu = LeNet5(10).build("cpu", torch.Generator().manual_seed(SEED))
    start = [p.detach().to("cuda", copy=True) for p in cpu.parameters()]
    method, seen = LBFGS(0.05, history_size=3), []
    update = method.update

    def recording(grads, params, state, lr):
        seen.append(([g.detach().clone() for g in grads], lr))
        return update(grads, params, state, lr)
    method.update = recording
    opt = Optimizer(cpu, DataSet.array(digits, seed=SEED),
                    nn.ClassNLLCriterion(), batch_size=16, device="cpu")
    opt.set_optim_method(method).set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    again = LBFGS(0.05, history_size=3)
    state = again.init_state(start)
    for grads, lr in seen:
        state = again.update([g.to("cuda") for g in grads], start, state, lr)
    rel = max(float((a.cpu() - b).abs().max())
              / max(float(b.abs().max()), 1e-30)
              for a, b in zip(start, cpu.parameters()))
    check(len(seen) == 3 and rel <= TV_METHOD_RTOL,
          f"LBFGS on the card vs the CPU: {rel}")
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    # ResNet-50: the stem frozen by its scales, the rest trains
    model = reset.model()
    stem = model.layers[:2]
    for m in stem:
        m.set_scale_w(0.0).set_scale_b(0.0)
    before = snapshot(stem)
    rest = [p.detach().clone() for p in model.layers[2:].parameters()]
    try:
        opt = lr_opt(model, samples, RETRY_BATCH)
        losses, _ = run_iters(opt, LR_STEPS)
    finally:
        for m in stem:
            m.set_scale_w(1.0).set_scale_b(1.0)
    stem_params = [p for m in stem for p in m.parameters()]
    frozen = bit_equal([p.detach() for p in stem_params],
                       before[:len(stem_params)])
    moved = not bit_equal([p.detach() for p in
                           model.layers[2:].parameters()], rest)
    check(frozen and moved, f"scales: stem frozen {frozen}, rest moved "
          f"{moved}")
    return {"lbfgs_card_vs_cpu_max_rel_diff": rel,
            "lbfgs_tol": TV_METHOD_RTOL,
            "scales": {"stem_bit_equal": frozen, "rest_trained": moved,
                       "losses": [losses[k] for k in sorted(losses)]}}


def phase_train_longrun(lm_rows=()):
    """The training driver's long-run half on the card: accumulation and
    remat on ResNet-50 (B1, B2, B4, B5 on new shapes and paths), the LM
    under remat with EMA and a summary (B6, B7), the retry loop, the
    supervisor and preemption, asynchronous and remote snapshots, LBFGS
    and the layer-wise scales."""
    t0 = time.perf_counter()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    root = tempfile.mkdtemp(prefix="bigdl-torch-longrun-")
    try:
        with deterministic_cudnn():
            samples = synthetic_imagenet(TRAIN_BATCH * 2, SEED + 16)
            reset = Reset(resnet50(fuse=True))
            reps, launched, routes, accum = lr_accumulation(reset, samples)
            remat = lr_remat(reset, samples)
            lm, lm_launched = lr_lm(root)
            retry = lr_retry(reset, samples[:RETRY_IMAGES], root)
            ckpts = lr_checkpoints(reset, samples, root)
            other = lr_lbfgs_and_scales(reset, samples[:RETRY_IMAGES])
    finally:
        shutil.rmtree(root, ignore_errors=True)
        set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    del reset
    torch.cuda.empty_cache()
    accum["train_phase_max_memory_allocated"] = getattr(phase_train, "peak",
                                                        None)
    emit({"phase": "train_longrun", "gpu": gpu_line(),
          "cudnn_deterministic": True, "accumulation": accum,
          "remat": remat, "lm": lm, "retry": retry, "checkpoints": ckpts,
          **other, "wall_s": time.perf_counter() - t0})
    rows = kernel_rows(reps, launched, "train_longrun", routes)
    # B6 and B7 as phase train_lm measured them, with this path's launches
    (lm_counts, lm_routes) = lm_launched
    for row, key, rts in zip(lm_rows, ("flash", "flash_bwd"), lm_routes):
        rows.append({**row, "path": "train_longrun",
                     "launches": lm_counts[key], "route_launches": rts})
    return rows


# -- 15. train_records ----------------------------------------------------------

REC_BATCH = 256
# timed steps after one warm-up step: the prefetch queue's head start (the
# batches made during step 1) is spent within the first few, so the
# second half of the window is reported apart as the steady state
REC_STEPS = 3
REC_IMAGES = REC_BATCH * (1 + REC_STEPS)   # one epoch: exactly the run
REC_SHARDS = 8
REC_THREADS = 8
REC_CLASSES = 10                   # the CLI's default --class-num
CLI_IMAGES = 2 * REC_BATCH         # two batches an epoch
CLI_STEPS = 3
R20_BATCH = 128
R20_IMAGES = R20_BATCH * CLI_STEPS
MEANS, STDS = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
#: launches a CLI step makes: unfused float32, every BatchNorm on B1/B2
CLI_STEP_LAUNCHES = {"resnet50": 53, "resnet20": 19}
LOG_INTERVAL_STALE = 10            # no logged iteration in a timed run
# the straggler drop: a window of 12 waits gives a threshold from the 7th
# fetch on and a budget of one drop (1/12 <= 1/12 < 2/12) that no window
# end renews within the run's 11 fetches, so host jitter cannot add a
# second drop; the stall lands on the 7th batch
DROP_BATCH = 64
DROP_WINDOW = 12
DROP_ITERS = 10
DROP_AT = 7
DROP_STALL_S = 3.0
LENET_ATOL = 1e-4


class RecordToImage(Transformer):
    """A ``record_generator`` dict -> a LabeledImage of ``data / 255`` in
    float32, as the CLI's ``_load_samples`` rescales."""

    def __call__(self, it):
        for rec in it:
            yield img_mod.LabeledImage(
                np.asarray(rec["data"]).astype(np.float32) / 255.0,
                float(rec["label"]))


def write_corpus(root, n, hw, seed):
    """``n`` seeded uint8 ``.npy`` images of ``hw`` x ``hw`` x 3 in
    ``REC_CLASSES`` class folders under ``root``."""
    rs = np.random.default_rng(seed)
    imgs = rs.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    for c in range(REC_CLASSES):
        os.makedirs(os.path.join(root, f"class_{c:02d}"), exist_ok=True)
    for i in range(n):
        np.save(os.path.join(root, f"class_{i % REC_CLASSES:02d}",
                             f"img_{i:05d}.npy"), imgs[i])
    return root


def etl(folder, out):
    """``record_generator.convert`` of ``folder`` into ``REC_SHARDS``
    shards: its numbers, and the shards' glob."""
    t0 = time.perf_counter()
    paths, n = record_generator.convert(folder, out, shards=REC_SHARDS,
                                        parallel=REC_THREADS, quiet=True)
    sec = time.perf_counter() - t0
    check(n == sum(count_records(p) for p in paths) and
          len(paths) == REC_SHARDS, f"ETL of {folder}: {n} records")
    return {"records": n, "shards": len(paths), "seconds": sec,
            "records_per_s": n / sec,
            "bytes_on_disk": sum(os.path.getsize(p) for p in paths)}, \
        out + "-*"


def aug_chain():
    """The ImageNet recipe's augmentation, one seeded generator each."""
    return (img_mod.RdmResizedCrop(224, 224, seed=SEED)
            >> img_mod.HFlip(seed=SEED + 1)
            >> img_mod.ColorJitter(seed=SEED + 2)
            >> img_mod.Lighting(seed=SEED + 3)
            >> img_mod.ImgNormalizer(MEANS, STDS))


def augmented(source, batch=None, chain=None):
    """A dataset of record dicts -> augmented MiniBatches of ``batch``
    (default ``REC_BATCH``)."""
    return source.transform(RecordToImage()).transform(
        img_mod.MTImageToBatch(batch or REC_BATCH, chain or aug_chain(),
                               drop_last=True))


def timed_steps(model, dataset, steps, log_interval=1, on_step=None):
    """``1 + steps`` Optimizer steps over ``dataset`` (SGD(0.1)); the
    window from batch 2 in hand (the card synchronized, every count
    zeroed) to the end holds ``steps`` steps.  Returns the window's ms per
    step, its data wait per fetch and share, the launches and routes in
    it, the losses and the first batch's latency."""
    marks, losses, started = {}, {}, set()
    t_start = time.perf_counter()

    def end(state):
        n = state["neval"]
        if n > 1:
            losses[n - 1] = state["loss"]
        if on_step is not None and n not in started and n <= steps + 1:
            started.add(n)
            on_step(n)
        if n == 2 and n not in marks:
            torch.cuda.synchronize()
            zero_counts()
        if n > steps + 1:
            torch.cuda.synchronize()
        # the last call for n: batch n in hand (or the run's end)
        marks[n] = (time.perf_counter(),
                    opt.metrics.get("get batch time average")[0])
        return n > steps + 1

    opt = Optimizer(model, dataset, nn.CrossEntropyCriterion(),
                    device="cuda")
    opt.set_optim_method(SGD(0.1)).set_log_interval(log_interval)
    opt.set_end_when(Trigger(end, "steps")).optimize()
    # step k: from batch k in hand to batch k + 1 in hand, its fetch's
    # wait included; the last step ends at the run's end (no fetch)
    each = [((marks[k + 1][0] - marks[k][0]) * 1e3,
             (marks[k + 1][1] - marks[k][1]) * 1e3)
            for k in range(2, steps + 2)]

    def window(rows):
        ms = sum(r[0] for r in rows)
        wait = sum(r[1] for r in rows)
        return {"steps": len(rows), "step_ms": ms / len(rows),
                "images_per_s": REC_BATCH * len(rows) / (ms / 1e3),
                "data_wait_ms": wait / len(rows),
                "data_wait_share": wait / ms}
    out = {**window(each), "steady": window(each[len(each) // 2:]),
           "step_ms_each": [r[0] for r in each],
           "data_wait_ms_each": [r[1] for r in each],
           "first_batch_ms": (marks[1][0] - t_start) * 1e3,
           "losses": [losses[k] for k in sorted(losses)],
           "launches": counts(), "route_launches": route_counts()}
    # between logged iterations a trigger sees the step before last's loss:
    # NaN before step 1's is read
    seen = out["losses"][1:] if log_interval > 1 else out["losses"]
    check(len(out["losses"]) == steps + 1 and
          all(map(math.isfinite, seen)) and
          math.isfinite(opt.optim_method.hyper["loss"]),
          f"losses {out['losses']}")
    return out


def check_fused_launches(run, what):
    want = {k: v * run["steps"] for k, v in STEP_LAUNCHES.items()}
    check(run["launches"] == want, f"{what}: launches {run['launches']}")
    check_step_routes(run["launches"], what)


def pipeline_rate(dataset, batches=None):
    """Records/s of one pass of ``dataset`` alone (bench.py ``--data``'s
    measure), or of its first ``batches`` batches."""
    t0 = time.perf_counter()
    n = 0
    it = dataset.data(train=True)
    for i, b in enumerate(it):
        n += b.size()
        if batches is not None and i + 1 == batches:
            it.close()
            break
    return n / (time.perf_counter() - t0)


class CountingPrefetch(native.NativePrefetchReader):
    """The native prefetcher, counting the readers opened."""

    opened = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        CountingPrefetch.opened += 1


def rec_augmentation(model, pattern256):
    """The augmentation path from shards: stream and cached, the array
    path and the stale loss read beside it, the pipeline alone, and a
    profile of the streamed steps."""
    def stream():
        return DataSet.record_stream(pattern256, num_threads=REC_THREADS,
                                     seed=SEED)

    out = {"stream": timed_steps(model, augmented(stream()), REC_STEPS)}
    check_fused_launches(out["stream"], "record_stream steps")
    t0 = time.perf_counter()
    cached = DataSet.record_files(pattern256, num_threads=REC_THREADS,
                                  seed=SEED)
    load_s = time.perf_counter() - t0
    out["cached"] = timed_steps(model, augmented(cached), REC_STEPS)
    out["cached"]["load_records_per_s"] = len(cached.records) / load_s
    check_fused_launches(out["cached"], "record_files steps")
    del cached
    # the train phase's path: DataSet.array of ready images, the loss read
    # every step (1) and between logged iterations only (10), A B B A
    samples = synthetic_imagenet(REC_IMAGES, SEED + 21)
    arr = {1: [], LOG_INTERVAL_STALE: []}
    for li in (1, LOG_INTERVAL_STALE, LOG_INTERVAL_STALE, 1):
        ds = DataSet.array(samples, seed=SEED).transform(
            SampleToMiniBatch(REC_BATCH, drop_last=True))
        run = timed_steps(model, ds, REC_STEPS, log_interval=li)
        check_fused_launches(run, f"array steps, log interval {li}")
        arr[li].append(run["step_ms"])
    out["array"] = {"step_ms_log_every_step": arr[1],
                    "step_ms_log_interval_10": arr[LOG_INTERVAL_STALE]}
    del samples
    out["pipeline_records_per_s"] = {
        "stream_mt_batcher": pipeline_rate(augmented(stream())),
        "stream_sequential_2_batches": pipeline_rate(
            stream().transform(RecordToImage()).transform(
                aug_chain() >> img_mod.ImgToSample()).transform(
                SampleToMiniBatch(REC_BATCH, drop_last=True)), batches=2)}
    out["host_ms_per_batch"] = REC_BATCH / out["pipeline_records_per_s"][
        "stream_mt_batcher"] * 1e3
    prof = profile_step(lambda mark: timed_steps(
        model, augmented(stream()), PROFILE_STEPS, on_step=mark))
    check("profile_error" not in prof, f"profile: {prof}")
    out["profile"] = {k: prof[k] for k in ("device_busy_ms",
                                           "device_idle_share", "steady",
                                           "first_step")}
    out["profile"]["top_kernels"] = prof["top_kernels"][:8]
    return out


def rec_straggler(model, pattern224):
    """One ``data.stall`` at batch ``DROP_AT`` under the straggler drop:
    exactly that iteration dropped, and the run's recorded waits replayed
    through a fresh Optimizer's ``_straggler_check`` decide the same."""
    def dataset():
        return augmented(DataSet.record_files(pattern224,
                                              num_threads=REC_THREADS,
                                              seed=SEED),
                         DROP_BATCH, img_mod.ImgNormalizer(MEANS, STDS))

    def optimizer(ds):
        o = Optimizer(model, ds, nn.CrossEntropyCriterion(), device="cuda")
        p = 1.0 / DROP_WINDOW
        return o.set_drop_module_property(p, p, batch_size=DROP_WINDOW,
                                          warmup_iteration=0)

    opt = optimizer(dataset())
    calls, check_fn = [], opt._straggler_check

    def recorded(wait, neval, queue_depth=None):
        out = check_fn(wait, neval, queue_depth=queue_depth)
        calls.append((wait, neval, queue_depth, out))
        return out
    opt._straggler_check = recorded
    opt.set_optim_method(SGD(0.1)).set_end_when(
        Trigger(lambda st: st["neval"] > DROP_ITERS, "iterations"))
    with chaos.scoped(f"data.stall=stall*{DROP_STALL_S}@{DROP_AT}"):
        opt.optimize()
    dropped = [i + 1 for i, c in enumerate(calls) if c[3]]
    check(dropped == [DROP_AT] and
          opt.metrics.get("dropped iterations") == (1.0, 1) and
          opt.optim_method.hyper["neval"] == DROP_ITERS + 1,
          f"straggler drop: fetches dropped {dropped}, calls {calls}")
    replay = optimizer(dataset())
    decisions = [replay._straggler_check(w, n, queue_depth=q)
                 for w, n, q, _ in calls]
    check(decisions == [c[3] for c in calls],
          f"replayed decisions {decisions} vs {calls}")
    return {"dropped_fetches": dropped, "fetches": len(calls),
            "waits_ms": [c[0] * 1e3 for c in calls],
            "queue_depths": [c[2] for c in calls],
            "stalled_wait_ms": calls[DROP_AT - 1][0] * 1e3}


@contextlib.contextmanager
def default_tf32():
    """PyTorch's default TF32 settings, whatever an earlier phase set:
    cuDNN's float32 convolutions in TF32, cuBLAS's float32 products not."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class StepLog(logging.Handler):
    """Each logged iteration's computing time (batch in hand to its loss
    read, in ms) from the Optimizer's INFO line and its throughput."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.ms = []

    def emit(self, record):
        if record.msg.startswith("Epoch %d [iteration %d]"):
            self.ms.append(REC_BATCH / record.args[4] * 1e3)


def rec_cli(root, pattern224, pattern32):
    """The zoo CLI: ResNet-50 trained, saved, tested; ResNet-20 trained.
    Float32, unfused, as the CLI trains, with PyTorch's default TF32
    settings, as a fresh ``python -m bigdl_torch.models.run`` has them."""
    set_policy(DTypePolicy())
    out = {}
    steps = StepLog()
    opt_logger = logging.getLogger("bigdl_torch")
    level = opt_logger.level
    opt_logger.setLevel(logging.INFO)
    opt_logger.addHandler(steps)
    with deterministic_cudnn(), default_tf32():
        saved = os.path.join(root, "resnet50.bigdl")
        zero_counts()
        t0 = time.perf_counter()
        opt = zoo_run.main(["train", "--model", "resnet50", "--data",
                            pattern224, "--batch-size", str(REC_BATCH),
                            "--max-iteration", str(CLI_STEPS),
                            "--model-save", saved])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        opt_logger.removeHandler(steps)
        opt_logger.setLevel(level)
        check(len(steps.ms) == CLI_STEPS, f"CLI step log {steps.ms}")
        launched, routes = counts(), route_counts()
        n = CLI_STEP_LAUNCHES["resnet50"] * CLI_STEPS
        want = dict.fromkeys(launched, 0)
        want.update(bn_forward=n, bn_backward=n)
        check(launched == want, f"CLI resnet50 launches {launched}")
        check_step_routes(launched, "CLI resnet50 steps")
        cli_launched = launched
        zero_counts()
        t0 = time.perf_counter()
        results = zoo_run.main(["test", "--model", "resnet50", "--snapshot",
                                saved, "--data", pattern224, "--batch-size",
                                str(REC_BATCH)])
        test_s = time.perf_counter() - t0
        check(not any(counts().values()), f"CLI test launches {counts()}")
        live = Evaluator(opt.model).test(
            DataSet.array(zoo_run._load_samples(pattern224, None)),
            [Top1Accuracy(), Top5Accuracy()], batch_size=REC_BATCH)
        got = [(r.correct, r.count) for _, r in results]
        check(got == [(r.correct, r.count) for _, r in live] and
              got[0][1] == CLI_IMAGES, f"CLI test {got} vs live {live}")
        out["resnet50"] = {
            "steps": CLI_STEPS, "train_s": train_s, "test_s": test_s,
            "precision": "float32 policy, cuDNN convolutions in TF32",
            "computing_ms_each": steps.ms,
            "loss": opt.optim_method.hyper["loss"],
            "top1_top5": got, "launches": launched, "route_launches": routes,
            "model_file_bytes": os.path.getsize(saved),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del opt, live
        torch.cuda.empty_cache()
        zero_counts()
        opt = zoo_run.main(["train", "--model", "resnet", "--data",
                            pattern32, "--batch-size", str(R20_BATCH),
                            "--max-iteration", str(CLI_STEPS)])
        launched = counts()
        n = CLI_STEP_LAUNCHES["resnet20"] * CLI_STEPS
        want = dict.fromkeys(launched, 0)
        want.update(bn_forward=n, bn_backward=n)
        check(launched == want and math.isfinite(
            opt.optim_method.hyper["loss"]),
              f"CLI resnet20 launches {launched}")
        check_step_routes(launched, "CLI resnet20 steps")
        out["resnet20"] = {"steps": CLI_STEPS, "launches": launched,
                           "route_launches": route_counts(),
                           "loss": opt.optim_method.hyper["loss"]}
    # the CLI set the root logger to INFO: quiet again for later phases
    logging.getLogger().setLevel(logging.WARNING)
    return out, cli_launched


def lenet_run(model, dev, x, g, capture=None):
    """``update_output``, ``backward`` and ``update_parameters(0.01)`` of
    ``model`` on ``dev``: the output, the input's gradient, each leaf's
    gradient by name and the flat parameters after, on the host.
    ``capture`` (a dict) receives conv1's input, weight and output
    gradient as the backward saw them."""
    hook = None
    if capture is not None:
        conv1 = next(m for m in model.layers if m.get_name() == "conv1_5x5")

        def grab(mod, inputs, out):
            if out.requires_grad:            # the backward's recompute
                capture.update(x=inputs[0].detach(),
                               w=mod.weight.detach().clone())
                out.register_hook(
                    lambda gy: capture.update(dy=gy.detach()))
        hook = conv1.register_forward_hook(grab)
    try:
        xx, gg = x.to(dev), g.to(dev)
        res = {"output": model.update_output(xx),
               "grad_input": model.backward(xx, gg)}
        for (mod, name), gr in zip(model._leaf_names(),
                                   model.weights_and_grads()[1]):
            res[f"{mod.get_name()}.{name}"] = gr.clone()
        model.update_parameters(0.01)
        res["params_after"] = model.get_parameters()[0]
        return {k: v.detach().cpu() for k, v in res.items()}
    finally:
        if hook is not None:
            hook.remove()


def conv_wgrad(x, w, dy):
    """The weight gradient of one unpadded stride-1 convolution as
    ``SpatialConvolution`` computes it: NHWC input, HWIO weight, NHWC
    output gradient."""
    w = w.detach().requires_grad_()
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    return torch.autograd.grad(y, w, dy)[0]


def executed_plans(lines):
    """Each plan a cuDNN API log (``CUDNN_LOGLEVEL_DBG=3``) shows executed:
    its operation, engine id, knobs and numerical notes."""
    out, cur = [], None
    for line in lines:
        if "function cudnnBackendExecute() called" in line:
            cur = {"operation": None, "engine": None, "knobs": {},
                   "numerical_notes": []}
            out.append(cur)
        elif cur is None:
            continue
        elif "function " in line and " called" in line:
            cur = None
        elif m := re.search(r"operation: type=CUDNN_BACKEND_OPERATION_"
                            r"(\w+)_DESCRIPTOR", line):
            cur["operation"] = m.group(1)
        elif m := re.search(r"engine_id: type=int; val=(-?\d+);", line):
            cur["engine"] = int(m.group(1))
        elif m := re.search(r"CUDNN_KNOB_TYPE_(\w+): type=int; "
                            r"val=(-?\d+);", line):
            cur["knobs"][m.group(1)] = int(m.group(2))
        elif m := re.search(r"CUDNN_NUMERICAL_NOTE_(\w+): type=bool; "
                            r"val=true;", line):
            cur["numerical_notes"].append(m.group(1))
    return out


def cudnn_probe_child(path):
    """``--cudnn-probe``: conv1's weight gradient of the saved input,
    weight and output gradient on the card, TF32 off, saved beside them
    (the parent reads the cuDNN log this process wrote)."""
    d = np.load(path)
    torch.backends.cudnn.allow_tf32 = False
    gw = conv_wgrad(*(torch.from_numpy(d[k]).cuda() for k in ("x", "w",
                                                              "dy")))
    np.save(path[:-4] + "-gw.npy", gw.cpu().numpy())
    return 0


def cudnn_probe(x, w, dy):
    """The plan cuDNN runs for conv1's weight gradient: ``conv_wgrad`` of
    the captured tensors in a child process under cuDNN's API log.  The
    executed backward-filter plans, and the child's gradient."""
    root = tempfile.mkdtemp(prefix="bigdl-torch-cudnn-")
    try:
        path = os.path.join(root, "wgrad.npz")
        np.savez(path, **{k: t.cpu().numpy() for k, t in
                          (("x", x), ("w", w), ("dy", dy))})
        log = os.path.join(root, "cudnn.log")
        env = dict(os.environ, CUDNN_LOGLEVEL_DBG="3", CUDNN_LOGDEST_DBG=log)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--cudnn-probe", path], env=env, check=True,
                       timeout=300, stdout=subprocess.DEVNULL)
        with open(log, errors="replace") as f:
            plans = [p for p in executed_plans(f)
                     if p["operation"] == "CONVOLUTION_BACKWARD_FILTER"]
        return plans, torch.from_numpy(np.load(path[:-4] + "-gw.npy"))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def rec_lenet_facade():
    """LeNet-5 through the stateful facade on the card and on the CPU,
    float32 with TF32 off.

    On the card cuDNN's (default, and deterministic) and PyTorch's own
    convolutions: every value within ``LENET_ATOL`` of the CPU's, but for
    one.  cuDNN's weight gradient of conv1 (one input channel, 28 x 28,
    16 images) is ~1e-3 of its magnitude from the exact (float64) one
    where the CPU's is ~1e-6, under every algorithm choice.  That one is held to
    cuDNN itself and to float32's bound instead: it equals ``conv_wgrad``
    of the captured input and output gradient on the card bit for bit (the
    gap is the library's, not the facade's), and it is within the
    a-priori error bound of a float32 sum of n = N*Ho*Wo products,
    ``gamma_n * sum |x| |dy|``, gamma_n = n u / (1 - n u), u = 2**-24, of
    the exact (float64) gradient of those tensors.  A child process under
    cuDNN's API log names the engine that computes it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rs = np.random.default_rng(SEED)
        x = torch.from_numpy(rs.standard_normal((16, 28, 28, 1),
                                                dtype=np.float32))
        g = torch.from_numpy(rs.standard_normal((16, 10), dtype=np.float32))
        set_policy(DTypePolicy())
        cpu = LeNet5(10).build("cpu", torch.Generator().manual_seed(SEED))
        runs = {"cpu": lenet_run(cpu.clone_module(), "cpu", x, g)}
        cap = {}
        for leg in ("cudnn", "cudnn_deterministic", "cudnn_off"):
            torch.backends.cudnn.enabled = leg != "cudnn_off"
            with (deterministic_cudnn() if leg == "cudnn_deterministic"
                  else contextlib.nullcontext()):
                runs[leg] = lenet_run(cpu.clone_module().to("cuda"), "cuda",
                                      x, g, cap if leg == "cudnn" else None)
            torch.backends.cudnn.enabled = True
        out = {"tol": LENET_ATOL, "vs_cpu": {
            leg: {k: float((v - runs["cpu"][k]).abs().max())
                  for k, v in r.items()}
            for leg, r in runs.items() if leg != "cpu"}}
        loose = "conv1_5x5.weight"
        for leg, d in out["vs_cpu"].items():
            strict = {k: v for k, v in d.items()
                      if leg == "cudnn_off" or k != loose}
            check(max(strict.values()) <= LENET_ATOL,
                  f"LeNet facade card ({leg}) vs CPU {out}")
        # conv1's weight gradient under cuDNN: the library's, and in bound
        exact = conv_wgrad(*(cap[k].cpu().double() for k in ("x", "w",
                                                            "dy")))
        sum_abs = conv_wgrad(cap["x"].cpu().double().abs(),
                             cap["w"].cpu().double(),
                             cap["dy"].cpu().double().abs())
        n = cap["dy"].shape[0] * cap["dy"].shape[1] * cap["dy"].shape[2]
        u = 2.0 ** -24
        gamma = n * u / (1 - n * u)
        lone = conv_wgrad(cap["x"], cap["w"], cap["dy"]).cpu()
        cpu32 = conv_wgrad(*(cap[k].cpu() for k in ("x", "w",
                                                    "dy"))).double()
        plans, child = cudnn_probe(cap["x"], cap["w"], cap["dy"])
        err = (lone.double() - exact).abs()
        wg = {"reduction_length": n, "gamma_n": gamma,
              "max_abs": float(exact.abs().max()),
              "max_sum_abs_terms": float(sum_abs.max()),
              "card_err": float(err.max()),
              "cpu_float32_err": float((cpu32 - exact).abs().max()),
              "card_err_over_bound": float((err / (gamma * sum_abs)).max()),
              "lone_equals_facade": {
                  leg: bool(torch.equal(lone, runs[leg][loose]))
                  for leg in ("cudnn", "cudnn_deterministic")},
              "child_equals_lone": bool(torch.equal(child, lone)),
              "cudnn_version": torch.backends.cudnn.version(),
              "plans": plans}
        out["conv1_wgrad"] = wg
        check(all(wg["lone_equals_facade"].values()) and
              wg["child_equals_lone"] and len(plans) == 1 and
              wg["card_err_over_bound"] <= 1.0,
              f"LeNet conv1 weight gradient under cuDNN: {wg}")
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled) = old


def phase_train_records(train_rows=()):
    """Train ResNet-50 on the card from BDRecord shards (phase 15)."""
    t0 = time.perf_counter()
    crc32c.native()
    native.library()                     # a failed build raises here
    check(native.is_native_loaded() and native.has_prefetch() and
          crc32c.route().startswith("compiled"),
          f"host routes: native {native.is_native_loaded()}, crc32c "
          f"{crc32c.route()}")
    root = tempfile.mkdtemp(prefix="bigdl-torch-records-")
    prefetch_cls, native.NativePrefetchReader = \
        native.NativePrefetchReader, CountingPrefetch
    def part(name, out):
        emit({"phase": "train_records", "part": name, **out})
        return out

    try:
        sets = {}
        for name, n, hw in (("256", REC_IMAGES, 256), ("224", CLI_IMAGES, 224),
                            ("32", R20_IMAGES, 32)):
            folder = write_corpus(os.path.join(root, f"img{name}"), n, hw,
                                  SEED + hw)
            sets[name] = etl(folder, os.path.join(root, f"bdr{name}",
                                                  "train"))
            shutil.rmtree(folder)
        part("etl", {k: v[0] for k, v in sets.items()})
        set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
        model = resnet50(fuse=True)
        aug = part("augmentation", rec_augmentation(model, sets["256"][1]))
        strag = part("straggler", rec_straggler(model, sets["224"][1]))
        del model
        torch.cuda.empty_cache()
        check(CountingPrefetch.opened > 0, "the native prefetcher never ran")
        cli, cli_launched = rec_cli(root, sets["224"][1], sets["32"][1])
        part("cli", cli)
        lenet = rec_lenet_facade()
    finally:
        native.NativePrefetchReader = prefetch_cls
        shutil.rmtree(root, ignore_errors=True)
        set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    torch.cuda.empty_cache()
    emit({"phase": "train_records", "gpu": gpu_line(),
          "host_routes": {"native": True, "crc32c": crc32c.route(),
                          "native_prefetch_readers": CountingPrefetch.opened},
          "step_ms": {"stream": aug["stream"]["step_ms"],
                      "stream_steady": aug["stream"]["steady"]["step_ms"],
                      "cached": aug["cached"]["step_ms"],
                      "cached_steady": aug["cached"]["steady"]["step_ms"],
                      "array": aug["array"]},
          "data_wait_share": {
              "stream": aug["stream"]["data_wait_share"],
              "stream_steady": aug["stream"]["steady"]["data_wait_share"],
              "cached": aug["cached"]["data_wait_share"],
              "cached_steady": aug["cached"]["steady"]["data_wait_share"]},
          "pipeline_records_per_s": aug["pipeline_records_per_s"],
          "etl_records_per_s": {k: v[0]["records_per_s"]
                                for k, v in sets.items()},
          "idle_share_steady": aug["profile"]["steady"]["device_idle_share"],
          "straggler_dropped": strag["dropped_fetches"],
          "cli_top1_top5": cli["resnet50"]["top1_top5"],
          "lenet_facade": lenet, "wall_s": time.perf_counter() - t0})
    rows = []
    stream = aug["stream"]
    for row in train_rows:
        rows.append({**row, "path": "train_records",
                     "launches": stream["launches"][row["name"]],
                     "route_launches": stream["route_launches"][row["name"]]})
        if cli_launched[row["name"]]:    # B1 and B2: the CLI trains unfused
            rows.append({**row, "path": "train_records_cli",
                         "launches": cli_launched[row["name"]],
                         "route_launches": cli["resnet50"][
                             "route_launches"][row["name"]]})
    return rows


# -- 16. train_ptb ------------------------------------------------------------

#: the repo's ``lstm`` config (bench.py ``_cfg_lstm``)
PTB = dict(vocab_size=10000, embed_size=200, hidden_size=200, num_layers=2)
PTB_BATCH = 64
PTB_T = 35
PTB_LR = 0.1
PTB_STEPS = 10
PTB_WARMUP = 2          # steps left out of the median
PTB_PROFILE_STEPS = 5
PTB_CPU_STEPS = 3
PTB_CPU_ATOL = 1e-3
#: the host's own CUDA waits in a profile (the rest of a step's wall time
#: is the host issuing work)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def all_kernel_counts():
    """Launches of every kernel of the repo, B1 to B8, since the counts
    were last zeroed."""
    out = counts()
    out["flash_attention"], out["flash_attention_bwd"] = flash_counts()
    out["decode_attention"] = dec_ops.decode_attention.launches
    return out


def zero_all_kernels():
    zero_counts()
    zero_flash()
    dec_ops.decode_attention.launches = 0
    zero_routes(dec_ops.decode_attention)


def ptb_samples(n, seed):
    """``n`` sequences of ``PTB_T`` seeded random tokens and their next
    tokens."""
    toks = np.random.default_rng(seed).integers(
        0, PTB["vocab_size"], (n, PTB_T + 1)).astype(np.int32)
    return [Sample(toks[i, :-1], toks[i, 1:]) for i in range(n)]


def ptb_model(device):
    from bigdl_torch.models import PTBModel
    return PTBModel(**PTB).build(device, torch.Generator().manual_seed(SEED))


def ptb_criterion():
    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)


def ptb_train(device, samples, steps, on_step=None):
    return train(ptb_model(device), samples, steps, PTB_BATCH, device=device,
                 criterion=ptb_criterion(), method=SGD(PTB_LR),
                 on_step=on_step)


def ptb_profile(samples):
    return window_profile(lambda mark: ptb_train("cuda", samples,
                                                 1 + PTB_PROFILE_STEPS,
                                                 on_step=mark),
                          PTB_PROFILE_STEPS)


def window_profile(run, n):
    """``run(on_step)`` (``1 + n`` steps, ``on_step(k)`` as step k starts)
    under ``torch.profiler``; over the last ``n`` (from step 2's start):
    the device's busy ms and idle share, kernel launches and memory copies
    a step (by name), and the host's ms a step (the window less the
    host's CUDA waits).  The profiler's own cost is in the window's wall
    time (the unprofiled steps' time is the phase's ``median_step_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(lambda k: _mark(f"chip_smoke.step{k}"))
            torch.cuda.synchronize()
            _mark("chip_smoke.end")
        marks, device, waits = {}, [], []
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device.append(e)
            elif e.name.startswith("chip_smoke."):
                marks.setdefault(e.name[len("chip_smoke."):],
                                 e.time_range.start)
            elif e.name in SYNC_CALLS:
                waits.append(e)
        lo, hi = marks["step2"], marks["end"]
    except (RuntimeError, AttributeError, KeyError) as e:
        return {"profile_error": str(e).splitlines()[0][:200]}

    def inside(e):
        return lo <= e.time_range.start and e.time_range.end <= hi
    kernels = [e for e in device if inside(e) and "Memcpy" not in e.name
               and "Memset" not in e.name]
    copies = [e for e in device if inside(e) and e not in kernels]
    wall = (hi - lo) / 1e3
    busy = _device_ms(device, lo, hi)
    wait = _device_ms(waits, lo, hi)
    by_name = collections.Counter(e.name[:80] for e in kernels)
    return {"profiled_steps": n, "wall_ms_per_step": wall / n,
            "device_busy_ms_per_step": busy / n,
            "device_idle_share": 1 - busy / wall,
            "launches_per_step": len(kernels) / n,
            "copies_per_step": len(copies) / n,
            "host_ms_per_step": (wall - wait) / n,
            "host_wait_ms_per_step": wait / n,
            "top_kernels_by_count": [
                {"name": k, "per_step": c / n}
                for k, c in by_name.most_common(12)],
            "copies_by_name": {k: c / n for k, c in collections.Counter(
                e.name[:60] for e in copies).most_common(6)}}


def phase_train_ptb():
    """The ``lstm`` config trained on the card (module docstring, 16)."""
    set_policy(DTypePolicy())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    samples = ptb_samples(PTB_BATCH * PTB_STEPS, SEED)
    zero_all_kernels()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated, so the peak is the run's own
    start_bytes = torch.cuda.memory_allocated()
    marks, host = StepMarks(), {}

    def on_step(n):
        host[n] = time.perf_counter()
        marks(n)
    t0 = time.perf_counter()
    losses = ptb_train("cuda", samples, PTB_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = all_kernel_counts()
    check(not any(launched.values()),
          f"train_ptb launched the repo's kernels: {launched}")
    check(len(losses) == PTB_STEPS and all(map(math.isfinite, losses)),
          f"train_ptb losses {losses}")
    ev = marks.events
    step_ms = [ev[k].elapsed_time(ev[k + 1]) for k in range(1, PTB_STEPS + 1)]
    median_ms = float(np.median(step_ms[PTB_WARMUP:]))
    host_ms = [(host[k + 1] - host[k]) * 1e3 for k in range(1, PTB_STEPS + 1)]
    again = ptb_train("cuda", samples, PTB_STEPS)
    check(again == losses, f"train_ptb: two runs from one seed differ: "
          f"{losses} vs {again}")
    cpu = ptb_train("cpu", samples, PTB_CPU_STEPS)
    diff = max(abs(a - b) for a, b in zip(cpu, losses))
    check(diff <= PTB_CPU_ATOL, f"train_ptb: card {losses[:PTB_CPU_STEPS]} "
          f"vs CPU {cpu}")
    prof = ptb_profile(samples)
    check("profile_error" not in prof, f"train_ptb profile: {prof}")
    tokens = PTB_BATCH * PTB_T
    emit({"phase": "train_ptb", "gpu": gpu_line(), "config": dict(
              PTB, batch=PTB_BATCH, T=PTB_T, lr=PTB_LR, criterion=
              "TimeDistributedCriterion(ClassNLLCriterion(), "
              "size_average=True)", precision="float32, TF32 off, bf16 "
              "gradient wire"),
          "steps": PTB_STEPS, "losses": losses,
          "bit_equal_rerun": True, "cpu_losses": cpu,
          "cpu_max_abs_diff": diff, "step_ms_each": step_ms,
          "median_step_ms": median_ms,
          "median_host_step_ms": float(np.median(host_ms[PTB_WARMUP:])),
          "tokens_per_s": tokens / (median_ms / 1e3),
          "run_s": run_s, "max_memory_allocated": peak,
          "peak_bytes_over_start": peak - start_bytes,
          "launches_of_repo_kernels": launched, "profile": prof})


# -- 17. layers ---------------------------------------------------------------

#: every class this slice exported from ``bigdl_torch.nn``
SLICE16_CLASSES = (
    "ReLU6", "PReLU", "RReLU", "LeakyReLU", "ELU", "TanhShrink", "Sigmoid",
    "SoftMax", "SoftMin", "SoftPlus", "SoftSign", "SoftShrink", "HardShrink",
    "HardTanh", "Threshold", "LogSigmoid",
    "Power", "Sqrt", "Square", "Clamp", "Max", "Min", "Mean", "Sum", "Exp",
    "Log", "Abs", "Scale", "MM", "MV", "Cosine", "Euclidean", "DotProduct",
    "PairwiseDistance", "CosineDistance",
    "InferReshape", "View", "Transpose", "Replicate", "Squeeze", "Unsqueeze",
    "Select", "Narrow", "Index", "MaskedSelect", "Reverse", "Padding",
    "SpatialZeroPadding", "Contiguous",
    "CSubTable", "CMulTable", "CDivTable", "CMaxTable", "CMinTable",
    "JoinTable", "SplitTable", "NarrowTable", "FlattenTable", "SelectTable",
    "MixtureTable", "Pack",
    "Bilinear", "CMul", "CAdd", "Mul", "Add",
    "ParallelTable", "MapTable", "Echo", "Bottle", "GradientReversal",
    "Cell", "RnnCell", "LSTM", "LSTMPeephole", "GRU", "Recurrent",
    "TimeDistributed", "BiRecurrent",
    "AbsCriterion", "BCECriterion", "ClassSimplexCriterion",
    "CosineDistanceCriterion", "CosineEmbeddingCriterion",
    "DiceCoefficientCriterion", "DistKLDivCriterion",
    "HingeEmbeddingCriterion", "L1Cost", "L1HingeEmbeddingCriterion",
    "L1Penalty", "MarginCriterion", "MarginRankingCriterion", "MSECriterion",
    "MultiCriterion", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion",
    "ParallelCriterion", "SmoothL1Criterion", "SmoothL1CriterionWithWeights",
    "SoftMarginCriterion", "SoftmaxWithCriterion")
#: every class slice 17 exported from ``bigdl_torch.nn`` (with ``Input``
#: and ``ModuleNode``, which are not modules, through the ``Graph`` case)
SLICE17_CLASSES = (
    "SpatialDilatedConvolution", "SpatialFullConvolution",
    "TemporalConvolution", "VolumetricConvolution", "SpatialShareConvolution",
    "SpatialConvolutionMap", "Normalize", "SpatialCrossMapLRN",
    "SpatialWithinChannelLRN", "SpatialSubtractiveNormalization",
    "SpatialDivisiveNormalization", "SpatialContrastiveNormalization",
    "VolumetricMaxPooling", "RoiPooling", "ConvLSTMPeephole",
    "ConvLSTMPeephole3D", "Graph", "Input", "ModuleNode", "TreeLSTM",
    "BinaryTreeLSTM", "Nms")
#: card against CPU, float32, TF32 off: of the larger of 1 and the CPU's
#: largest magnitude
LAYER_RTOL = 1e-4
SEQ_STEPS = 3
SEQ_ATOL = 1e-3
AE_IMAGES = 256
AE_BATCH = 64


def _xn(shape, seed=0, positive=False, scale=1.0):
    v = np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32) * scale
    return np.abs(v) + 0.5 if positive else v


def _labels(shape, n, seed=0):
    return np.random.RandomState(seed).randint(0, n, shape).astype(np.int64)


def _signs(shape, seed=0):
    return np.where(np.random.RandomState(seed).rand(*shape) > 0.5, 1.0,
                    -1.0).astype(np.float32)


def _probs(shape, seed):
    return (1.0 / (1.0 + np.exp(-_xn(shape, seed)))).astype(np.float32)


def _binary(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) > 0.5).astype(
        np.float32)


def _log_probs(shape, seed):
    v = _xn(shape, seed)
    return (v - np.log(np.exp(v).sum(-1, keepdims=True))).astype(np.float32)


_W5 = np.linspace(0.5, 2.0, 5).astype(np.float32)

#: name -> (module over ``nn``, its inputs); small sizes, eval mode
LAYER_CASES = {
    "ReLU6": (lambda: nn.ReLU6(), lambda: _xn((3, 5), scale=5.0)),
    "PReLU": (lambda: nn.PReLU(5), lambda: _xn((2, 3, 5))),
    "RReLU": (lambda: nn.RReLU(0.1, 0.3), lambda: _xn((3, 5))),
    "LeakyReLU": (lambda: nn.LeakyReLU(0.2), lambda: _xn((3, 5))),
    "ELU": (lambda: nn.ELU(0.7), lambda: _xn((3, 5))),
    "TanhShrink": (lambda: nn.TanhShrink(), lambda: _xn((3, 5))),
    "Sigmoid": (lambda: nn.Sigmoid(), lambda: _xn((3, 5))),
    "SoftMax": (lambda: nn.SoftMax(), lambda: _xn((3, 5))),
    "SoftMin": (lambda: nn.SoftMin(), lambda: _xn((3, 5))),
    "SoftPlus": (lambda: nn.SoftPlus(2.0), lambda: _xn((3, 5))),
    "SoftSign": (lambda: nn.SoftSign(), lambda: _xn((3, 5))),
    "SoftShrink": (lambda: nn.SoftShrink(0.5), lambda: _xn((3, 5))),
    "HardShrink": (lambda: nn.HardShrink(0.5), lambda: _xn((3, 5))),
    "HardTanh": (lambda: nn.HardTanh(-0.5, 0.8), lambda: _xn((3, 5))),
    "Threshold": (lambda: nn.Threshold(0.1, -1.0), lambda: _xn((3, 5))),
    "LogSigmoid": (lambda: nn.LogSigmoid(), lambda: _xn((3, 5))),
    "Power": (lambda: nn.Power(2.5, 0.5, 1.0),
              lambda: _xn((3, 5), positive=True)),
    "Sqrt": (lambda: nn.Sqrt(), lambda: _xn((3, 5), positive=True)),
    "Square": (lambda: nn.Square(), lambda: _xn((3, 5))),
    "Clamp": (lambda: nn.Clamp(-0.5, 0.5), lambda: _xn((3, 5))),
    "Max": (lambda: nn.Max(1), lambda: _xn((3, 5, 2))),
    "Min": (lambda: nn.Min(-1), lambda: _xn((3, 5))),
    "Mean": (lambda: nn.Mean(1, squeeze=False), lambda: _xn((3, 5, 2))),
    "Sum": (lambda: nn.Sum(2, size_average=True), lambda: _xn((3, 5, 4))),
    "Exp": (lambda: nn.Exp(), lambda: _xn((3, 5))),
    "Log": (lambda: nn.Log(), lambda: _xn((3, 5), positive=True)),
    "Abs": (lambda: nn.Abs(), lambda: _xn((3, 5))),
    "Scale": (lambda: nn.Scale((5,)), lambda: _xn((3, 5))),
    "MM": (lambda: nn.MM(trans_b=True),
           lambda: [_xn((2, 3, 4)), _xn((2, 5, 4), 1)]),
    "MV": (lambda: nn.MV(), lambda: [_xn((2, 3, 4)), _xn((2, 4), 1)]),
    "Cosine": (lambda: nn.Cosine(4, 3), lambda: _xn((2, 4))),
    "Euclidean": (lambda: nn.Euclidean(4, 3), lambda: _xn((2, 4))),
    "DotProduct": (lambda: nn.DotProduct(),
                   lambda: [_xn((3, 4)), _xn((3, 4), 1)]),
    "PairwiseDistance": (lambda: nn.PairwiseDistance(2),
                         lambda: [_xn((3, 4)), _xn((3, 4), 1)]),
    "CosineDistance": (lambda: nn.CosineDistance(),
                       lambda: [_xn((3, 4)), _xn((3, 4), 1)]),
    "InferReshape": (lambda: nn.InferReshape((0, -1)),
                     lambda: _xn((2, 3, 4))),
    "View": (lambda: nn.View(-1, 4), lambda: _xn((2, 3, 4))),
    "Transpose": (lambda: nn.Transpose([(1, 2), (0, 1)]),
                  lambda: _xn((2, 3, 4))),
    "Replicate": (lambda: nn.Replicate(3, 1), lambda: _xn((2, 4))),
    "Squeeze": (lambda: nn.Squeeze(1), lambda: _xn((2, 1, 4))),
    "Unsqueeze": (lambda: nn.Unsqueeze(1), lambda: _xn((2, 4))),
    "Select": (lambda: nn.Select(1, -1), lambda: _xn((2, 3, 4))),
    "Narrow": (lambda: nn.Narrow(1, 1, -2), lambda: _xn((2, 5, 4))),
    "Index": (lambda: nn.Index(1),
              lambda: [_xn((2, 5, 3)), np.array([4, 0, 4], np.int64)]),
    "MaskedSelect": (lambda: nn.MaskedSelect(),
                     lambda: [_xn((3, 4)), (_xn((3, 4), 7) > 0)]),
    "Reverse": (lambda: nn.Reverse(1), lambda: _xn((2, 3, 4))),
    "Padding": (lambda: nn.Padding(1, -2, value=0.5),
                lambda: _xn((2, 3, 4))),
    "SpatialZeroPadding": (lambda: nn.SpatialZeroPadding(1, 2, 0, 1),
                           lambda: _xn((2, 3, 4, 2))),
    "Contiguous": (lambda: nn.Sequential().add(nn.Transpose([(0, 1)]))
                   .add(nn.Contiguous()), lambda: _xn((2, 3))),
    "CSubTable": (lambda: nn.CSubTable(),
                  lambda: [_xn((3, 4)), _xn((3, 4), 1)]),
    "CMulTable": (lambda: nn.CMulTable(),
                  lambda: [_xn((3, 4)), _xn((3, 4), 1), _xn((3, 4), 2)]),
    "CDivTable": (lambda: nn.CDivTable(),
                  lambda: [_xn((3, 4)), _xn((3, 4), 1, positive=True)]),
    "CMaxTable": (lambda: nn.CMaxTable(),
                  lambda: [_xn((3, 4)), _xn((3, 4), 1), _xn((3, 4), 2)]),
    "CMinTable": (lambda: nn.CMinTable(),
                  lambda: [_xn((3, 4)), _xn((3, 4), 1)]),
    "JoinTable": (lambda: nn.JoinTable(1),
                  lambda: [_xn((2, 3)), _xn((2, 4), 1)]),
    "SplitTable": (lambda: nn.SplitTable(1), lambda: _xn((2, 3, 4))),
    "NarrowTable": (lambda: nn.NarrowTable(0, -2),
                    lambda: [_xn((2, 3)), _xn((2, 3), 1), _xn((2, 3), 2)]),
    "FlattenTable": (lambda: nn.FlattenTable(),
                     lambda: [_xn((3, 4)), [_xn((3, 4), 1),
                                            [_xn((2, 2), 2)]]]),
    "SelectTable": (lambda: nn.SelectTable(2),
                    lambda: [_xn((2, 3)), _xn((2, 4), 1), _xn((2, 5), 2)]),
    "MixtureTable": (lambda: nn.MixtureTable(),
                     lambda: [_probs((2, 3), 3),
                              [_xn((2, 4), 10 + i) for i in range(3)]]),
    "Pack": (lambda: nn.Pack(1),
             lambda: [_xn((2, 3)), _xn((2, 3), 1), _xn((2, 3), 2)]),
    "Bilinear": (lambda: nn.Bilinear(3, 4, 2),
                 lambda: [_xn((2, 3)), _xn((2, 4), 1)]),
    "CMul": (lambda: nn.CMul((1, 5)), lambda: _xn((3, 5))),
    "CAdd": (lambda: nn.CAdd((5,)), lambda: _xn((3, 5))),
    "Mul": (lambda: nn.Mul(), lambda: _xn((3, 5))),
    "Add": (lambda: nn.Add(5), lambda: _xn((3, 5))),
    "ParallelTable": (lambda: nn.ParallelTable().add(nn.Linear(4, 3))
                      .add(nn.Sigmoid()),
                      lambda: [_xn((2, 4)), _xn((2, 3), 1)]),
    "MapTable": (lambda: nn.MapTable(nn.Linear(4, 3)),
                 lambda: [_xn((2, 4)), _xn((2, 4), 1)]),
    "Echo": (lambda: nn.Echo(), lambda: _xn((3, 5))),
    "Bottle": (lambda: nn.Bottle(nn.Linear(4, 3), 2),
               lambda: _xn((2, 3, 4))),
    "GradientReversal": (lambda: nn.GradientReversal(0.7),
                         lambda: _xn((3, 5))),
    "RnnCell": (lambda: nn.Recurrent(nn.RnnCell(5, 6)),
                lambda: _xn((3, 4, 5))),
    "LSTM": (lambda: nn.Recurrent(nn.LSTM(5, 6)), lambda: _xn((3, 4, 5))),
    "LSTMPeephole": (lambda: nn.Recurrent(nn.LSTMPeephole(5, 6)),
                     lambda: _xn((3, 4, 5))),
    "GRU": (lambda: nn.GRU(5, 6), lambda: _xn((3, 5))),
    "TimeDistributed": (lambda: nn.TimeDistributed(nn.Linear(5, 3)),
                        lambda: _xn((2, 4, 5))),
    "BiRecurrent": (lambda: nn.BiRecurrent(nn.GRU(5, 6), "concat"),
                    lambda: _xn((2, 4, 5))),
}

def _tied_rows():
    """Rows whose largest magnitude appears twice, with both signs."""
    v = _xn((3, 6), 4)
    v[:, 1], v[:, 4] = 3.0, -3.0
    return v


def _roi_case():
    """A map of small integers (tied maxima in most bins) and rois past
    its edges, one wholly outside (empty bins)."""
    feats = np.random.RandomState(7).randint(0, 3, (2, 8, 9, 3)).astype(
        np.float32)
    rois = np.array([[0, 0, 0, 8, 7], [1, 2.5, 1.5, 6.5, 5],
                     [1, 5, -3, 12, 4], [0, 20, 20, 30, 25]], np.float32)
    return [feats, rois]


def _diamond_graph():
    inp = nn.Input()
    h = nn.Linear(5, 4)(inp)
    out = nn.CAddTable()([nn.ReLU()(h), nn.Tanh()(h)])
    return nn.Graph(inp, nn.Linear(4, 3)(out))


def _two_trees():
    """Inputs and two trees of different shapes, padded to 7 nodes."""
    from bigdl_torch.models import encode_tree
    c0, l0, _ = encode_tree(((0, 1), 2), 7)
    c1, l1, _ = encode_tree((0, (1, (2, 3))), 7)
    return [_xn((2, 4, 5)), np.stack([c0, c1]), np.stack([l0, l1])]


def _nms_case():
    """30 boxes whose scores take five values (ties everywhere)."""
    rs = np.random.default_rng(SEED)
    xy = rs.uniform(0, 10, (30, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(1, 5, (30, 2))], 1)
    scores = np.round(rs.uniform(0, 1, 30) * 4) / 4
    return [boxes.astype(np.float32), scores.astype(np.float32)]


#: slice 17's classes: name -> (module over ``nn``, its inputs)
LAYER17_CASES = {
    "SpatialDilatedConvolution": (
        lambda: nn.SpatialDilatedConvolution(3, 4, 3, 2, 1, 2, 1, 0, 2, 3),
        lambda: _xn((2, 11, 10, 3))),
    "SpatialFullConvolution_adj_stride": (
        lambda: nn.SpatialFullConvolution(4, 6, 4, 3, 2, 2, 2, 1, 2, 2,
                                          n_group=2),
        lambda: _xn((2, 4, 5, 4))),
    "SpatialFullConvolution": (
        lambda: nn.SpatialFullConvolution(4, 6, 3, 4, 2, 3, 1, 1, 1, 2,
                                          n_group=2),
        lambda: _xn((2, 4, 5, 4))),
    "TemporalConvolution": (lambda: nn.TemporalConvolution(5, 7, 3, 2),
                            lambda: _xn((2, 11, 5))),
    "VolumetricConvolution": (
        lambda: nn.VolumetricConvolution(3, 4, 2, 3, 2, 1, 2, 1, 1, 1, 0),
        lambda: _xn((2, 5, 6, 7, 3))),
    "SpatialShareConvolution": (
        lambda: nn.SpatialShareConvolution(3, 4, 3, 3, 1, 1, 1, 1),
        lambda: _xn((2, 6, 7, 3))),
    "SpatialConvolutionMap": (
        lambda: nn.SpatialConvolutionMap(
            nn.SpatialConvolutionMap.random(4, 5, 2, 3), 3, 2, 1, 2, 1, 0,
            n_input_plane=4, n_output_plane=5),
        lambda: _xn((2, 7, 6, 4))),
    "Normalize": (lambda: nn.Normalize(2.0), lambda: _xn((3, 5))),
    "Normalize_inf_ties": (lambda: nn.Normalize(math.inf), _tied_rows),
    "SpatialCrossMapLRN": (lambda: nn.SpatialCrossMapLRN(5, 0.5, 0.75, 2.0),
                           lambda: _xn((2, 4, 3, 7))),
    "SpatialWithinChannelLRN": (
        lambda: nn.SpatialWithinChannelLRN(4, 1.0, 0.6),
        lambda: _xn((2, 6, 5, 2))),
    "SpatialSubtractiveNormalization": (
        lambda: nn.SpatialSubtractiveNormalization(3, 5),
        lambda: _xn((2, 7, 6, 3))),
    "SpatialDivisiveNormalization": (
        lambda: nn.SpatialDivisiveNormalization(3, 5),
        lambda: _xn((2, 7, 6, 3))),
    "SpatialContrastiveNormalization": (
        lambda: nn.SpatialContrastiveNormalization(3, 4),
        lambda: _xn((2, 7, 6, 3))),
    "VolumetricMaxPooling": (
        lambda: nn.VolumetricMaxPooling(2, 3, 2, 1, 2, 1, 1, 2, 0),
        lambda: _xn((2, 4, 5, 6, 2))),
    "RoiPooling_ties": (lambda: nn.RoiPooling(3, 2, 1.0), _roi_case),
    "ConvLSTMPeephole": (lambda: nn.Recurrent(nn.ConvLSTMPeephole(3, 4)),
                         lambda: _xn((2, 3, 5, 6, 3))),
    "ConvLSTMPeephole3D": (
        lambda: nn.Recurrent(nn.ConvLSTMPeephole3D(2, 3)),
        lambda: _xn((2, 3, 4, 5, 4, 2))),
    "Graph_diamond": (_diamond_graph, lambda: _xn((3, 5))),
    "BinaryTreeLSTM_two_trees": (lambda: nn.BinaryTreeLSTM(5, 6),
                                 _two_trees),
    "Nms_ties": (lambda: nn.Nms(0.5, 8), _nms_case),
}


def nms_without_sync():
    """``nms`` on the card under ``set_sync_debug_mode("error")``: the
    selection loop reads nothing back to the host (the result's host copy
    comes after)."""
    boxes, scores = (torch.from_numpy(a).cuda() for a in _nms_case())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, count = nn.detection.nms(boxes, scores, 0.5, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = nn.detection.nms(boxes.cpu(), scores.cpu(), 0.5, 8)
    check(torch.equal(idx.cpu(), cpu[0]) and int(count) == int(cpu[1]),
          f"nms on the card {idx.tolist()} vs host {cpu[0].tolist()}")
    return {"indices": idx.tolist(), "count": int(count),
            "sync_debug_mode": "error"}


#: name -> (criterion over ``nn``, output, target)
CRITERION_CASES = {
    "AbsCriterion": (lambda: nn.AbsCriterion(), lambda: _xn((4, 5)),
                     lambda: _xn((4, 5), 1)),
    "BCECriterion": (lambda: nn.BCECriterion(_W5),
                     lambda: _probs((4, 5), 0), lambda: _binary((4, 5), 1)),
    "ClassSimplexCriterion": (lambda: nn.ClassSimplexCriterion(5),
                              lambda: _xn((4, 5)),
                              lambda: _labels((4,), 5, 1)),
    "CosineDistanceCriterion": (lambda: nn.CosineDistanceCriterion(),
                                lambda: _xn((4, 5)),
                                lambda: _xn((4, 5), 1)),
    "CosineEmbeddingCriterion": (
        lambda: nn.CosineEmbeddingCriterion(0.1),
        lambda: [_xn((4, 5)), _xn((4, 5), 1)], lambda: _signs((4,), 2)),
    "DiceCoefficientCriterion": (
        lambda: nn.DiceCoefficientCriterion(epsilon=0.5),
        lambda: _probs((4, 3, 2), 0), lambda: _binary((4, 3, 2), 1)),
    "DistKLDivCriterion": (lambda: nn.DistKLDivCriterion(),
                           lambda: _log_probs((4, 5), 0),
                           lambda: np.exp(_log_probs((4, 5), 1))),
    "HingeEmbeddingCriterion": (lambda: nn.HingeEmbeddingCriterion(0.5),
                                lambda: _xn((4, 5)),
                                lambda: _signs((4, 5), 1)),
    "L1Cost": (lambda: nn.L1Cost(), lambda: _xn((4, 5)),
               lambda: _xn((4, 5), 1)),
    "L1HingeEmbeddingCriterion": (
        lambda: nn.L1HingeEmbeddingCriterion(4.0),
        lambda: [_xn((4, 5)), _xn((4, 5), 1)], lambda: _signs((4,), 2)),
    "L1Penalty": (lambda: nn.L1Penalty(0.3, True), lambda: _xn((4, 5)),
                  lambda: _xn((4, 5), 1)),
    "MarginCriterion": (lambda: nn.MarginCriterion(1.0, squared=True),
                        lambda: _xn((4, 5)), lambda: _signs((4, 5), 1)),
    "MarginRankingCriterion": (lambda: nn.MarginRankingCriterion(0.5),
                               lambda: [_xn((6,)), _xn((6,), 1)],
                               lambda: _signs((6,), 2)),
    "MSECriterion": (lambda: nn.MSECriterion(), lambda: _xn((4, 5)),
                     lambda: _xn((4, 5), 1)),
    "MultiCriterion": (lambda: nn.MultiCriterion()
                       .add(nn.MSECriterion(), 0.5)
                       .add(nn.AbsCriterion(), 2.0),
                       lambda: _xn((4, 5)), lambda: _xn((4, 5), 1)),
    "MultiLabelMarginCriterion": (
        lambda: nn.MultiLabelMarginCriterion(),
        lambda: _xn((4, 5)),
        lambda: np.array([[3, 0, -1], [1, -1, -1], [4, 2, 1],
                          [-1, -1, -1]], np.int64)),
    "MultiLabelSoftMarginCriterion": (
        lambda: nn.MultiLabelSoftMarginCriterion(_W5),
        lambda: _xn((4, 5)), lambda: _binary((4, 5), 1)),
    "MultiMarginCriterion": (lambda: nn.MultiMarginCriterion(2, _W5, 0.7),
                             lambda: _xn((4, 5)),
                             lambda: _labels((4,), 5, 1)),
    "ParallelCriterion": (lambda: nn.ParallelCriterion()
                          .add(nn.MSECriterion())
                          .add(nn.ClassNLLCriterion(), 0.5),
                          lambda: [_xn((4, 5)), _log_probs((4, 3), 1)],
                          lambda: [_xn((4, 5), 2), _labels((4,), 3, 3)]),
    "SmoothL1Criterion": (lambda: nn.SmoothL1Criterion(),
                          lambda: _xn((4, 5), scale=2.0),
                          lambda: _xn((4, 5), 1)),
    "SmoothL1CriterionWithWeights": (
        lambda: nn.SmoothL1CriterionWithWeights(2.0, 3),
        lambda: _xn((4, 5), scale=2.0),
        lambda: [_xn((4, 5), 1), _binary((4, 5), 2),
                 _xn((4, 5), 3, positive=True)]),
    "SoftMarginCriterion": (lambda: nn.SoftMarginCriterion(),
                            lambda: _xn((4, 5)), lambda: _signs((4, 5), 1)),
    "SoftmaxWithCriterion": (lambda: nn.SoftmaxWithCriterion(1),
                             lambda: _xn((2, 3, 3, 4)),
                             lambda: _labels((2, 3, 3), 4, 1)),
    "TimeDistributedCriterion": (
        lambda: nn.TimeDistributedCriterion(nn.MSECriterion(), True),
        lambda: _xn((3, 4, 5)), lambda: _xn((3, 4, 5), 1)),
}


def _flat(t):
    if isinstance(t, (list, tuple)):
        return [v for e in t for v in _flat(e)]
    return [t]


def _unflat(like, leaves):
    it = iter(leaves)

    def rec(t):
        if isinstance(t, (list, tuple)):
            return [rec(e) for e in t]
        return next(it)
    return rec(like)


def _slice_classes(objs):
    """Slices 16's and 17's classes among the classes (and their bases) of
    ``objs``; a ``Graph`` also reaches ``Input`` and ``ModuleNode``."""
    names = set()
    for o in objs:
        for cls in type(o).__mro__:
            if cls.__name__ in SLICE16_CLASSES + SLICE17_CLASSES and \
                    getattr(nn, cls.__name__, None) is cls:
                names.add(cls.__name__)
        if isinstance(o, nn.Graph) and all(
                isinstance(n, nn.ModuleNode) for n in o.exec_order):
            names |= {"Input", "ModuleNode"}
    return names


def _criteria(c):
    yield c
    for inner in getattr(c, "criterions", ()):
        yield from _criteria(inner)
    if hasattr(c, "critrn"):
        yield from _criteria(c.critrn)


def _err(card, cpu):
    card = card.detach().float().cpu()
    cpu = cpu.detach().float()
    if tuple(card.shape) != tuple(cpu.shape):
        return math.inf
    if not cpu.numel():
        return 0.0
    scale = max(1.0, float(cpu.abs().max()))
    return float((card - cpu).abs().max()) / scale


def _run_module(m, inputs, device, cts):
    leaves = [torch.as_tensor(np.array(a)).to(device) for a in
              _flat(inputs)]
    for t in leaves:
        if t.is_floating_point():
            t.requires_grad_()
    out = m(_unflat(inputs, leaves))
    outs = _flat(out)
    pairs = [(o, torch.from_numpy(c).to(device)) for o, c in zip(outs, cts)
             if o.requires_grad]
    if pairs:
        torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in leaves if t.is_floating_point()]
    pgrads = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in m.parameters()]
    return outs, grads, pgrads


def layer_card_vs_cpu(name, make, inputs):
    """The module built on the host, a copy on the card: forward, input
    gradients and parameter gradients in eval mode; the largest error
    relative to the larger of 1 and the CPU's largest magnitude."""
    cpu_m = make().build("cpu", torch.Generator().manual_seed(SEED)).eval()
    card_m = copy.deepcopy(cpu_m).to("cuda")
    x = inputs()
    rs = np.random.RandomState(SEED + 101)
    with contextlib.redirect_stdout(io.StringIO()):   # Echo prints
        cpu_out = cpu_m(_unflat(x, [torch.as_tensor(np.array(a))
                                    for a in _flat(x)]))
        cts = [rs.standard_normal(tuple(o.shape)).astype(np.float32)
               for o in _flat(cpu_out)]
        cpu_res = _run_module(cpu_m, x, "cpu", cts)
        card_res = _run_module(card_m, x, "cuda", cts)
    errs = [_err(a, b) for part_a, part_b in zip(card_res, cpu_res)
            for a, b in zip(part_a, part_b)]
    check(len(card_res[2]) == len(cpu_res[2]),
          f"layers {name}: parameter counts differ")
    return max(errs, default=0.0), _slice_classes(card_m.modules())


def criterion_card_vs_cpu(name, make, output, target):
    out, tgt = output(), target()
    errs, crit = [], None
    res = {}
    for device in ("cpu", "cuda"):
        crit = make()
        outs = [torch.as_tensor(np.array(o)).to(device).requires_grad_()
                for o in _flat(out)]
        tl = _unflat(tgt, [torch.as_tensor(np.array(t)).to(device)
                           for t in _flat(tgt)])
        loss = crit(_unflat(out, outs), tl)
        loss.backward()
        res[device] = [loss] + [o.grad for o in outs]
    errs = [_err(a, b) for a, b in zip(res["cuda"], res["cpu"])]
    return max(errs), _slice_classes(_criteria(crit))


def rrelu_training_card():
    """RReLU in training on the card: slopes in [lower, upper], the same
    output twice from one generator state."""
    m = nn.RReLU(0.1, 0.3).build("cuda").train()
    x = torch.from_numpy(_xn((256, 64))).cuda()
    outs = []
    for _ in range(2):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        with nn.dropout_rng(gen):
            outs.append(m(x))
    neg = x < 0
    slopes = outs[0][neg] / x[neg]
    lo, hi = float(slopes.min()), float(slopes.max())
    check(torch.equal(outs[0], outs[1]) and lo >= 0.1 - 1e-6 and
          hi <= 0.3 + 1e-6 and torch.equal(outs[0][~neg], x[~neg]),
          f"RReLU training on the card: slopes [{lo}, {hi}]")
    return {"slope_min": lo, "slope_max": hi, "bit_equal_repeat": True}


def seq_model_steps():
    """SimpleRNN, BiRecurrent(GRU) and Autoencoder(32) with MSECriterion:
    ``SEQ_STEPS`` steps on the card and on the host from one seed, the
    losses finite and within ``SEQ_ATOL``."""
    from bigdl_torch.models import Autoencoder, SimpleRNN
    V, T, B = 16, 12, 8
    rs = np.random.default_rng(SEED + 16)
    toks = rs.integers(0, V, (B * SEQ_STEPS, T + 1))
    onehot = np.eye(V, dtype=np.float32)[toks[:, :-1]]
    seq = [Sample(onehot[i], toks[i, 1:].astype(np.int32))
           for i in range(len(toks))]
    imgs = rs.random((B * SEQ_STEPS, 28, 28, 1), dtype=np.float32)
    ae = [Sample(imgs[i], imgs[i].reshape(-1)) for i in range(len(imgs))]
    per_step = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), True)
    models = {
        "SimpleRNN": (lambda: SimpleRNN(V, 32, V), seq, per_step),
        "BiRecurrent_GRU": (
            lambda: nn.Sequential().add(nn.BiRecurrent(nn.GRU(V, 24),
                                                       "concat"))
            .add(nn.TimeDistributed(nn.Linear(48, V))), seq, per_step),
        "Autoencoder": (lambda: Autoencoder(32), ae, nn.MSECriterion()),
    }
    out = {}
    for name, (make, samples, crit) in models.items():
        losses = {}
        for device in ("cuda", "cpu"):
            model = make().build(device, torch.Generator().manual_seed(SEED))
            losses[device] = train(model, samples, SEQ_STEPS, B,
                                   device=device, criterion=crit,
                                   method=SGD(0.5))
        card, cpu = losses["cuda"], losses["cpu"]
        diff = max(abs(a - b) for a, b in zip(card, cpu))
        check(all(map(math.isfinite, card)) and diff <= SEQ_ATOL,
              f"{name} on the card {card} vs the host {cpu}")
        out[name] = {"card": card, "cpu": cpu, "max_abs_diff": diff}
    return out


def ae_cli(root):
    """The zoo CLI trains and tests ``--model autoencoder`` from BDRecord
    shards of seeded 28 x 28 x 1 images written by
    ``tools/record_generator.py``."""
    folder = os.path.join(root, "mnist_like")
    rs = np.random.default_rng(SEED + 28)
    imgs = rs.integers(0, 256, (AE_IMAGES, 28, 28, 1), dtype=np.uint8)
    for c in range(REC_CLASSES):
        os.makedirs(os.path.join(folder, f"class_{c:02d}"), exist_ok=True)
    for i in range(AE_IMAGES):
        np.save(os.path.join(folder, f"class_{i % REC_CLASSES:02d}",
                             f"img_{i:05d}.npy"), imgs[i])
    etl_row, pattern = etl(folder, os.path.join(root, "ae", "train"))
    saved = os.path.join(root, "ae.bigdl")
    set_policy(DTypePolicy())
    zero_all_kernels()
    t0 = time.perf_counter()
    opt = zoo_run.main(["train", "--model", "autoencoder", "--data", pattern,
                        "--batch-size", str(AE_BATCH), "--max-iteration",
                        str(SEQ_STEPS), "--model-save", saved])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    results = zoo_run.main(["test", "--model", "autoencoder", "--snapshot",
                            saved, "--data", pattern, "--batch-size",
                            str(AE_BATCH)])
    logging.getLogger().setLevel(logging.WARNING)
    loss = opt.optim_method.hyper["loss"]
    got = [(r.correct, r.count) for _, r in results]
    check(isinstance(opt.criterion, nn.MSECriterion) and math.isfinite(loss)
          and opt.optim_method.hyper["neval"] == SEQ_STEPS + 1
          and got[0][1] == AE_IMAGES and
          next(opt.model.parameters()).is_cuda,
          f"CLI autoencoder: loss {loss}, test {got}")
    launched = all_kernel_counts()
    check(not any(launched.values()), f"CLI autoencoder launched {launched}")
    return {"etl": etl_row, "steps": SEQ_STEPS, "loss": loss,
            "train_s": train_s, "top1_top5": got,
            "model_file_bytes": os.path.getsize(saved)}


def phase_layers():
    """Every class this slice exported, card against host (module
    docstring, 17)."""
    set_policy(DTypePolicy())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checked, worst = set(), {}
    zero_all_kernels()
    for name, (make, inputs) in LAYER_CASES.items():
        err, names = layer_card_vs_cpu(name, make, inputs)
        check(err <= LAYER_RTOL, f"layers {name}: card vs host {err}")
        worst[name], checked = err, checked | names
    for name, (make, output, target) in CRITERION_CASES.items():
        err, names = criterion_card_vs_cpu(name, make, output, target)
        check(err <= LAYER_RTOL, f"layers {name}: card vs host {err}")
        worst[name], checked = err, checked | names
    for name, (make, inputs) in LAYER17_CASES.items():
        err, names = layer_card_vs_cpu(name, make, inputs)
        check(err <= LAYER_RTOL, f"layers {name}: card vs host {err}")
        worst[name], checked = err, checked | names
    nms_sync = nms_without_sync()
    exported = set(SLICE16_CLASSES) | set(SLICE17_CLASSES)
    check(exported <= set(nn.__all__), f"not exported: "
          f"{sorted(exported - set(nn.__all__))}")
    check(checked == exported, f"layers checked {sorted(checked ^ exported)}"
          " unlike the slice's exports")
    rrelu = rrelu_training_card()
    seq = seq_model_steps()
    launched = all_kernel_counts()
    check(not any(launched.values()), f"layers launched {launched}")
    with tempfile.TemporaryDirectory() as root:
        cli = ae_cli(root)
    emit({"phase": "layers", "gpu": gpu_line(), "classes": len(checked),
          "cases": len(worst), "max_rel_err": max(worst.values()),
          "worst": sorted(worst.items(), key=lambda kv: -kv[1])[:5],
          "slice17_cases": {k: worst[k] for k in LAYER17_CASES},
          "nms_on_card": nms_sync,
          "rrelu_training": rrelu, "sequence_models": seq,
          "cli_autoencoder": cli})


# -- 18. train_zoo ------------------------------------------------------------

ZOO_STEPS = 10
ZOO_WARMUP = 2           # steps left out of the median
ZOO_BATCHES = 5          # distinct batches (an epoch) of each run's data
ZOO_PROFILE_STEPS = 5
ZOO_CPU_STEPS = 3
ZOO_CPU_ATOL = 1e-3
#: bench.py's inception_v1 config
INC_BATCH = 64
INC_LR = 0.1
#: bench.py's textcnn config
TEXT_BATCH = 128
TEXT_SEQ = 500
TEXT_EMBED = 200
TEXT_CLASSES = 20
TEXT_LR = 0.05
#: BN-Inception (``Inception_v2_NoAuxClassifier``, models/inception.py):
#: 69 conv-BN pairs, ``fuse_conv_bn`` makes the 37 adjacent 1x1 ones
#: ``ConvBN`` (B5 forward, B4 backward), the other 32 stay on B1 / B2
BNINC_STEP_LAUNCHES = {"bn_forward": 32, "bn_backward": 32, "bn_stats": 0,
                       "matmul_stats": 37, "bn_grad_stats": 37}
#: distinct shapes one step gives each kernel at batch 64
BNINC_STEP_SHAPES = {"bn_forward": 13, "bn_backward": 13,
                     "bn_grad_stats": 14, "matmul_stats": 16}
BNINC_LR = 0.1
#: bn_kernels' case beside BN-Inception's step shapes: C = 352 (44
#: 16-byte pieces, a last tile of 12 on B1) at R = 3136, in float32 and
#: bf16
BNINC_EXTRA = {"matmul_stats": [], "other": [(3136, 352)]}


def tf32_settings():
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def zoo_samples(shape, classes, n, seed):
    """``n`` seeded normal inputs of ``shape`` and labels."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((n,) + shape, dtype=np.float32)
    y = rs.integers(0, classes, n).astype(np.int32)
    return [Sample(x[i], y[i]) for i in range(n)]


def without_dropout(model):
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.set_p(0.0)
    return model


def zoo_train_run(make, samples, batch, method, criterion):
    """``ZOO_STEPS`` steps of a model from ``make()`` on the card (each
    step's ms from CUDA events, the median after ``ZOO_WARMUP``), the
    peak memory over what the run found allocated, the kernels of the
    repo launched, then a profile of ``1 + ZOO_PROFILE_STEPS`` steps."""
    model = make()
    zero_all_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    stats_before = [b.detach().clone() for b in model.buffers()]
    marks = StepMarks()
    t0 = time.perf_counter()
    losses = train(model, samples, ZOO_STEPS, batch, criterion=criterion,
                   method=method(), on_step=marks)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched, routes = all_kernel_counts(), route_counts()
    flash = flash_routes()
    moved = max((float((a.float() - b.float()).abs().max())
                 for a, b in zip(model.buffers(), stats_before)),
                default=None)
    ev = marks.events
    step_ms = [ev[k].elapsed_time(ev[k + 1]) for k in range(1, ZOO_STEPS + 1)]
    median = float(np.median(step_ms[ZOO_WARMUP:]))
    check(len(losses) == ZOO_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    prof = window_profile(lambda mark: train(
        model, samples, 1 + ZOO_PROFILE_STEPS, batch, criterion=criterion,
        method=method(), on_step=mark), ZOO_PROFILE_STEPS)
    check("profile_error" not in prof, f"profile: {prof}")
    del model
    torch.cuda.empty_cache()
    return {"steps": ZOO_STEPS, "losses": losses, "step_ms_each": step_ms,
            "median_step_ms": median, "per_s": batch / (median / 1e3),
            "run_s": run_s, "max_memory_allocated": peak,
            "peak_bytes_over_start": peak - start_bytes,
            "buffers_max_move": moved, "launches": launched,
            "route_launches": routes, "flash_routes": flash,
            "profile": prof}


def host_leg(make, samples, batch, method, criterion, tol=ZOO_CPU_ATOL):
    """The first ``ZOO_CPU_STEPS`` losses on the card (TF32 off, Dropout
    at p = 0) and on the host from the same seed: within ``tol``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        losses = {}
        for device in ("cuda", "cpu"):
            model = without_dropout(make(device))
            losses[device] = train(model, samples, ZOO_CPU_STEPS, batch,
                                   device=device, criterion=criterion,
                                   method=method())
            del model
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    torch.cuda.empty_cache()
    card, cpu = losses["cuda"], losses["cpu"]
    diff = max(abs(a - b) for a, b in zip(card, cpu))
    check(all(map(math.isfinite, card)) and diff <= tol,
          f"card {card} vs host {cpu}")
    return {"tf32": False, "dropout_p": 0.0, "card_losses": card,
            "cpu_losses": cpu, "max_abs_diff": diff, "tol": tol}


def zoo_float32(name, model_fn, shape, classes, batch, lr, seed, config):
    """(a) or (c): a float32 config of bench.py at full width (module
    docstring, 18), timed under PyTorch's default TF32 settings, with its
    TF32-off host leg."""
    set_policy(DTypePolicy())

    def make(device="cuda"):
        return model_fn().build(device, torch.Generator().manual_seed(SEED))

    def method():
        return SGD(lr)
    samples = zoo_samples(shape, classes, batch * ZOO_BATCHES, seed)
    crit = nn.ClassNLLCriterion()
    with default_tf32():
        tf32 = tf32_settings()
        run = zoo_train_run(make, samples, batch, method, crit)
    check(not any(run["launches"].values()),
          f"{name} launched the repo's kernels: {run['launches']}")
    host = host_leg(make, samples[:batch * ZOO_CPU_STEPS], batch, method,
                    crit)
    return {"config": {**config, "batch": batch, "dtype": "float32",
                       "criterion": "ClassNLLCriterion",
                       "method": f"SGD({lr})", "tf32": tf32},
            **run, "host_leg": host}


def zoo_inception_v1():
    """(a) The ``inception_v1`` config."""
    from bigdl_torch.models import Inception_v1_NoAuxClassifier
    out = zoo_float32("inception_v1",
                      lambda: Inception_v1_NoAuxClassifier(1000),
                      (224, 224, 3), 1000, INC_BATCH, INC_LR, SEED,
                      {"model": "Inception_v1_NoAuxClassifier(1000)",
                       "image": [224, 224, 3]})
    out["images_per_s"] = out.pop("per_s")
    return out


def zoo_textcnn():
    """(c) The ``textcnn`` config."""
    from bigdl_torch.models import TextClassifier
    out = zoo_float32("textcnn", lambda: TextClassifier(TEXT_CLASSES),
                      (TEXT_SEQ, TEXT_EMBED), TEXT_CLASSES, TEXT_BATCH,
                      TEXT_LR, SEED + 1,
                      {"model": f"TextClassifier({TEXT_CLASSES})",
                       "input": [TEXT_SEQ, TEXT_EMBED]})
    out["samples_per_s"] = out.pop("per_s")
    return out


def zoo_bn_inception():
    """(b) BN-Inception fused in bf16 on B1, B2, B4 and B5 (module
    docstring, 18); returns (the phase's part, the kernels line's rows)."""
    from bigdl_torch.models import Inception_v2_NoAuxClassifier
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))

    def make():
        m = Inception_v2_NoAuxClassifier(1000)
        nn.fuse_conv_bn(m)
        return m.build("cuda", torch.Generator().manual_seed(SEED))
    samples = zoo_samples((224, 224, 3), 1000, INC_BATCH * ZOO_BATCHES,
                          SEED + 2)
    crit = nn.ClassNLLCriterion()

    def method():
        return SGD(BNINC_LR, momentum=0.9)
    # a warm-up step recording every shape the step gives the kernels
    model = make()
    seen, handles = record_shapes(model)
    zero_counts()
    train(model, samples, 1, INC_BATCH, criterion=crit, method=method())
    for h in handles:
        h.remove()
    del model
    torch.cuda.empty_cache()
    check(counts() == BNINC_STEP_LAUNCHES, f"BN-Inception warm-up launches "
          f"{counts()}")
    check_step_routes(BNINC_STEP_LAUNCHES, "BN-Inception warm-up")
    for kind, n in BNINC_STEP_SHAPES.items():
        check(len(seen[kind]) == n and sum(seen[kind].values())
              == BNINC_STEP_LAUNCHES[kind],
              f"BN-Inception {kind} shapes {dict(seen[kind])}")
    reps = phase_bn_kernels(seen, BNINC_STEP_SHAPES, "train_zoo",
                            BNINC_EXTRA)
    run = zoo_train_run(make, samples, INC_BATCH, method, crit)
    rate = run.pop("per_s")
    launched = {k: run["launches"][k] for k in TRAIN_KERNELS}
    check(launched == {k: v * ZOO_STEPS for k, v in
                       BNINC_STEP_LAUNCHES.items()},
          f"BN-Inception launches over {ZOO_STEPS} steps: {launched}")
    for kind, rt in STEP_ROUTES.items():
        want = dict.fromkeys(run["route_launches"][kind], 0)
        want[rt] = launched[kind]
        check(run["route_launches"][kind] == want, f"BN-Inception "
              f"{kind} launches by route {run['route_launches'][kind]}")
    others = {k: v for k, v in run["launches"].items() if k not in launched}
    check(not any(others.values()), f"BN-Inception launched {others}")
    check(run["buffers_max_move"] > 0, "BN-Inception's running statistics "
          "did not move")
    part = {"config": {"model": "Inception_v2_NoAuxClassifier(1000)",
                       "fused": True, "batch": INC_BATCH,
                       "image": [224, 224, 3], "dtype": "bf16 compute, "
                       "float32 params", "criterion": "ClassNLLCriterion",
                       "method": f"SGD({BNINC_LR}, momentum=0.9)"},
            **run, "images_per_s": rate,
            "step_shapes": {k: len(v) for k, v in seen.items()},
            "kernel_ms_per_step": {k: t for k, (_, t) in reps.items()}}
    rows = kernel_rows(reps, launched, "train_zoo", run["route_launches"])
    return part, rows


def phase_train_zoo():
    """The zoo on the card (module docstring, 18): (a) Inception-v1, (b)
    BN-Inception on the training kernels, (c) the text CNN; returns the
    kernels line's rows of (b)."""
    t0 = time.perf_counter()
    inc = zoo_inception_v1()
    emit({"phase": "train_zoo", "part": "inception_v1", "gpu": gpu_line(),
          **inc})
    bn, rows = zoo_bn_inception()
    emit({"phase": "train_zoo", "part": "bn_inception", "gpu": gpu_line(),
          **bn})
    text = zoo_textcnn()
    emit({"phase": "train_zoo", "part": "textcnn", "gpu": gpu_line(),
          **text})
    phase_train_zoo.rates = {"inception_v1": {
        "phase": "train_zoo", "images_per_s": inc["images_per_s"],
        "config": "Optimizer from DataSet.array, float32, batch 64"}}
    emit({"phase": "train_zoo", "gpu": gpu_line(),
          "inception_v1": {k: inc[k] for k in (
              "median_step_ms", "images_per_s", "max_memory_allocated")},
          "bn_inception": {k: bn[k] for k in (
              "median_step_ms", "images_per_s", "max_memory_allocated")},
          "textcnn": {k: text[k] for k in (
              "median_step_ms", "samples_per_s", "max_memory_allocated")},
          "idle_share": {k: p["profile"]["device_idle_share"] for k, p in (
              ("inception_v1", inc), ("bn_inception", bn),
              ("textcnn", text))},
          "launches_per_step": {k: p["profile"]["launches_per_step"]
                                for k, p in (("inception_v1", inc),
                                             ("bn_inception", bn),
                                             ("textcnn", text))},
          "host_legs_max_abs_diff": {
              "inception_v1": inc["host_leg"]["max_abs_diff"],
              "textcnn": text["host_leg"]["max_abs_diff"]},
          "wall_s": time.perf_counter() - t0})
    return rows


# ---------------------------------------------------------------------------
# zoo_data: ViT, the CLI's vit, Wide & Deep, the int8 LM, SequenceFile
# shards and the perf CLI
# ---------------------------------------------------------------------------

#: ViT() at its ImageNet defaults (224², patch 16, d_model 384, 6 heads of
#: 64, 8 layers, 1000 classes) under the bf16 compute policy
VIT_BATCH = 128
VIT_LR = 0.01
#: launches a training step: one B6 (writing the log-sum-exp) a block, and
#: B7's two, 8 blocks
VIT_STEP = {"flash_attention": 8, "flash_attention_bwd": 16}
VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM = 6, 196, 64
VIT_EVAL_ROWS = 2 * VIT_BATCH
VIT_F32_BATCH = 8
#: the zoo CLI's vit (32², patch 4, 4 heads of 16, 4 layers, float32):
#: 3 iterations from a shard of 96 images
VIT_CLI_IMAGES = 96
VIT_CLI_BATCH = 32
VIT_CLI_STEPS = 3
VIT_CLI_LAYERS = 4
#: bench.py's widedeep config
WD_RECORDS = 512
WD_BATCH = 512
WD_LR = 0.05
WD_EMBED = 64
WD_HIDDEN = (256, 128)
WD_CPU_ATOL = 1e-4
#: SequenceFile shards of 28² images: one epoch of 3 LeNet-5 steps
SEQ_SHARDS = 2
SEQ_PER_SHARD = 96
SEQ_BATCH = 64
SEQ_STEPS = 3
#: the perf CLI's runs, each its own process
PERF_MODELS = ("inception_v1", "resnet50")
PERF_BATCH = 64
PERF_ITERS = 3
PERF_TIMEOUT = 300


class LossLog(logging.Handler):
    """The loss of each iteration the Optimizer logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.values = []

    def emit(self, record):
        if record.msg.startswith("Epoch %d [iteration %d]"):
            self.values.append(float(record.args[2]))


@contextlib.contextmanager
def logged_losses():
    log = LossLog()
    opt_logger = logging.getLogger("bigdl_torch")
    level = opt_logger.level
    opt_logger.setLevel(logging.INFO)
    opt_logger.addHandler(log)
    try:
        yield log
    finally:
        opt_logger.removeHandler(log)
        opt_logger.setLevel(level)
        # the CLI sets the root logger to INFO: quiet again
        logging.getLogger().setLevel(logging.WARNING)


def only_kernels(launched, want, what):
    """``launched`` (``all_kernel_counts()``) is ``want`` and zero for
    every other kernel."""
    full = dict.fromkeys(launched, 0)
    full.update(want)
    check(launched == full, f"{what}: kernel launches {launched}, want "
          f"{want} and no other")


def flash_routes():
    return {"flash_attention": dict(attn_ops.flash_attention.route_launches),
            "flash_attention_bwd": dict(
                attn_ops.flash_attention_bwd.route_launches),
            "flash_lse": attn_ops.flash_attention.lse_launches}


def kernel_row(case, name, source, replaces, launches, path, routes):
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "path": path,
           "shape": case["shape"], "dtype": case["dtype"],
           "causal": case.get("causal"), "max_abs_err": case["max_abs_err"],
           "ms": case["ms"], "plain_ms": case["plain_ms"],
           "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
           "library_ms": case["library_ms"],
           "ms_over_library": case["ms_over_library"],
           "kernel_route": case["route"], "route_launches": routes}
    for k in ("with_lse", "lse_max_abs_err", "ms_without_lse"):
        if k in case:
            row[k] = case[k]
    return row


B6_SRC = ("bigdl_torch/csrc/flash_attention.cu",
          "bigdl_tpu/ops/attention.py:59")
B7_SRC = ("bigdl_torch/csrc/flash_attention_bwd.cu",
          "bigdl_tpu/ops/attention.py:182")
B8_SRC = ("bigdl_torch/csrc/decode_attention.cu",
          "bigdl_tpu/serve/decode.py:129")


def zd_vit():
    """(a) ViT at full width on B6 and B7, not causal; returns (the
    part, the kernels line's rows)."""
    from bigdl_torch.models import ViT
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))

    def make(device="cuda"):
        return ViT().build(device, torch.Generator().manual_seed(SEED))

    def method():
        return SGD(VIT_LR, momentum=0.9)
    crit = nn.ClassNLLCriterion()
    mhas = [m for m in ViT().modules() if isinstance(m, nn.MultiHeadAttention)]
    check(len(mhas) == VIT_STEP["flash_attention"] and all(
        m.head_dim == VIT_HEAD_DIM and m.num_heads == VIT_HEADS
        and not m.causal for m in mhas), "ViT's attention blocks")
    samples = zoo_samples((224, 224, 3), 1000, VIT_BATCH * ZOO_BATCHES,
                          SEED + 3)
    run = zoo_train_run(make, samples, VIT_BATCH, method, crit)
    rate = run.pop("per_s")
    step_want = {k: v * ZOO_STEPS for k, v in VIT_STEP.items()}
    only_kernels(run["launches"], step_want, f"ViT over {ZOO_STEPS} steps")
    fr = run["flash_routes"]
    check(fr["flash_attention"] == {"tc": step_want["flash_attention"],
                                    "f32": 0}
          and fr["flash_attention_bwd"] == {
              "f32": 0, "tc": step_want["flash_attention_bwd"]}
          and fr["flash_lse"] == step_want["flash_attention"],
          f"ViT's flash routes {fr}")
    # an eval forward: B6 without the log-sum-exp, 8 a batch
    model = make()
    zero_all_kernels()
    x = np.stack([s.feature for s in samples[:VIT_EVAL_ROWS]])
    t0 = time.perf_counter()
    out = Predictor(model, batch_size=VIT_BATCH).predict(x)
    eval_s = time.perf_counter() - t0
    n_eval = VIT_STEP["flash_attention"] * VIT_EVAL_ROWS // VIT_BATCH
    only_kernels(all_kernel_counts(), {"flash_attention": n_eval},
                 "ViT eval")
    eval_routes = flash_routes()
    check(eval_routes["flash_lse"] == 0 and only_route(
        attn_ops.flash_attention, "tc", n_eval), f"ViT eval {eval_routes}")
    check(out.shape == (VIT_EVAL_ROWS, 1000) and np.isfinite(out).all(),
          f"ViT eval output {out.shape}")
    del model
    torch.cuda.empty_cache()
    # B6 (both instances) and B7 at ViT's call, against the plain versions
    gen = torch.Generator().manual_seed(SEED + 7)
    shape = (VIT_BATCH, VIT_HEADS, VIT_TOKENS, VIT_TOKENS, VIT_HEAD_DIM)
    b6 = {w: flash_case(*shape, torch.bfloat16, False, gen, with_lse=w)
          for w in (False, True)}
    b7 = b7_case(*shape, torch.bfloat16, False,
                 torch.Generator(device="cuda").manual_seed(SEED + 8))
    bad = [c for c in (b6[False], b6[True], b7) if not c["ok"]]
    check(not bad, f"B6 / B7 at ViT's call: {bad}")
    torch.cuda.empty_cache()
    # float32 (TF32 off, "f32"): 3 steps on the card and on the host
    set_policy(DTypePolicy())
    zero_all_kernels()
    host = host_leg(make, samples[:VIT_F32_BATCH * ZOO_CPU_STEPS],
                    VIT_F32_BATCH, method, crit)
    f32_want = {k: v * ZOO_CPU_STEPS for k, v in VIT_STEP.items()}
    only_kernels(all_kernel_counts(), f32_want, "ViT float32 leg")
    check(only_route(attn_ops.flash_attention, "f32",
                     f32_want["flash_attention"])
          and only_route(attn_ops.flash_attention_bwd, "f32",
                         f32_want["flash_attention_bwd"]),
          f"ViT float32 leg's routes {flash_routes()}")
    part = {"config": {"model": "ViT()", "image": [224, 224, 3],
                       "patch": 16, "d_model": 384, "heads": VIT_HEADS,
                       "layers": 8, "classes": 1000, "batch": VIT_BATCH,
                       "dtype": "bf16 compute, float32 params",
                       "criterion": "ClassNLLCriterion",
                       "method": f"SGD({VIT_LR}, momentum=0.9)"},
            **run, "images_per_s": rate,
            "launches_per_step": VIT_STEP,
            "eval": {"rows": VIT_EVAL_ROWS, "batch": VIT_BATCH,
                     "seconds": eval_s, "flash_launches": n_eval,
                     "routes": eval_routes},
            "cases": {"b6": b6[False], "b6_lse": b6[True], "b7": b7},
            "host_leg": host}
    rows = [kernel_row(b6[True], "flash_attention", *B6_SRC,
                       step_want["flash_attention"], "zoo_data vit",
                       fr["flash_attention"]),
            kernel_row(b6[False], "flash_attention", *B6_SRC, n_eval,
                       "zoo_data vit eval",
                       eval_routes["flash_attention"]),
            kernel_row(b7, "flash_attention_bwd", *B7_SRC,
                       step_want["flash_attention_bwd"], "zoo_data vit",
                       fr["flash_attention_bwd"])]
    return part, rows


def zd_vit_cli(root):
    """(b) The zoo CLI's vit (D = 16) from a BDRecord shard, float32 as
    the CLI trains; B6 and B7 at its call, D = 16."""
    from bigdl_torch.utils.recordio import write_records
    set_policy(DTypePolicy())
    rs = np.random.default_rng(SEED + 9)
    write_records(os.path.join(root, "vit"), [
        {"data": rs.integers(0, 256, (32, 32, 3), dtype=np.uint8),
         "label": float(i % REC_CLASSES)} for i in range(VIT_CLI_IMAGES)],
        shards=2)
    zero_all_kernels()
    with logged_losses() as log, default_tf32():
        t0 = time.perf_counter()
        opt = zoo_run.main(["train", "--model", "vit", "--data",
                            os.path.join(root, "vit-*"), "--batch-size",
                            str(VIT_CLI_BATCH), "--max-iteration",
                            str(VIT_CLI_STEPS)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    check(len(log.values) == VIT_CLI_STEPS
          and all(map(math.isfinite, log.values)),
          f"CLI vit losses {log.values}")
    mhas = [m for m in opt.model.modules()
            if isinstance(m, nn.MultiHeadAttention)]
    check(len(mhas) == VIT_CLI_LAYERS and all(
        m.head_dim == 16 and not m.causal for m in mhas),
        "the CLI's vit has 4 blocks of heads of 16")
    want = {"flash_attention": VIT_CLI_LAYERS * VIT_CLI_STEPS,
            "flash_attention_bwd": 2 * VIT_CLI_LAYERS * VIT_CLI_STEPS}
    only_kernels(all_kernel_counts(), want, "CLI vit")
    routes = flash_routes()
    check(only_route(attn_ops.flash_attention, "f32",
                     want["flash_attention"])
          and only_route(attn_ops.flash_attention_bwd, "f32",
                         want["flash_attention_bwd"]),
          f"CLI vit routes {routes}")
    del opt
    torch.cuda.empty_cache()
    shape = (VIT_CLI_BATCH, 4, 64, 64, 16)
    gen = torch.Generator().manual_seed(SEED + 10)
    b6 = flash_case(*shape, torch.float32, False, gen, with_lse=True)
    b7 = b7_case(*shape, torch.float32, False,
                 torch.Generator(device="cuda").manual_seed(SEED + 10))
    # the same call in bf16, on "tc"
    b6_tc = flash_case(*shape, torch.bfloat16, False, gen, with_lse=True)
    b7_tc = b7_case(*shape, torch.bfloat16, False,
                    torch.Generator(device="cuda").manual_seed(SEED + 11))
    bad = [c for c in (b6, b7, b6_tc, b7_tc) if not c["ok"]]
    check(not bad, f"B6 / B7 at D = 16: {bad}")
    part = {"steps": VIT_CLI_STEPS, "batch": VIT_CLI_BATCH,
            "seconds": seconds, "losses": log.values, "launches": want,
            "routes": routes,
            "cases": {"b6_f32": b6, "b7_f32": b7, "b6_tc": b6_tc,
                      "b7_tc": b7_tc}}
    rows = [kernel_row(b6, "flash_attention", *B6_SRC,
                       want["flash_attention"], "zoo_data vit cli",
                       routes["flash_attention"]),
            kernel_row(b7, "flash_attention_bwd", *B7_SRC,
                       want["flash_attention_bwd"], "zoo_data vit cli",
                       routes["flash_attention_bwd"]),
            kernel_row(b6_tc, "flash_attention", *B6_SRC, 0,
                       "zoo_data d16 tc case", {"tc": 0, "f32": 0}),
            kernel_row(b7_tc, "flash_attention_bwd", *B7_SRC, 0,
                       "zoo_data d16 tc case", {"f32": 0, "tc": 0})]
    return part, rows


def zd_widedeep():
    """(c) bench.py's widedeep config, then DLClassifier and
    UDFPredictor over the trained model."""
    from bigdl_torch.dataset import (FeatureSpec, TabularToSample,
                                     synthetic_criteo_records)
    from bigdl_torch.ml import DLClassifier
    from bigdl_torch.models import WideDeep
    from bigdl_torch.serving import UDFPredictor
    set_policy(DTypePolicy())
    spec = FeatureSpec()
    samples = list(TabularToSample(spec)(
        synthetic_criteo_records(WD_RECORDS, spec=spec, seed=1)))

    def make(device="cuda"):
        return WideDeep.from_spec(spec, embed_dim=WD_EMBED,
                                  hidden=WD_HIDDEN).build(
            device, torch.Generator().manual_seed(SEED))

    def method():
        return SGD(WD_LR)
    crit = nn.ClassNLLCriterion()
    with default_tf32():
        tf32 = tf32_settings()
        run = zoo_train_run(make, samples, WD_BATCH, method, crit)
    rate = run.pop("per_s")
    only_kernels(run["launches"], {}, "Wide & Deep")
    host = host_leg(make, samples, WD_BATCH, method, crit, tol=WD_CPU_ATOL)
    # the estimator and the UDF over the model it trains
    X = np.stack([s.feature for s in samples])
    y = np.array([s.label for s in samples], np.float32)
    zero_all_kernels()
    t0 = time.perf_counter()
    fitted = DLClassifier(make(), nn.ClassNLLCriterion(),
                          batch_size=WD_BATCH, max_epoch=1,
                          optim_method=SGD(WD_LR)).fit(X, y)
    fit_s = time.perf_counter() - t0
    udf_rows = UDFPredictor(fitted.model, postprocess=lambda o: o,
                            batch_size=WD_BATCH)(X)
    pred_rows = Predictor(fitted.model, batch_size=WD_BATCH).predict(X)
    classes = UDFPredictor(fitted.model, batch_size=WD_BATCH)(X)
    check(udf_rows.shape == (WD_RECORDS, 2) and np.array_equal(
        udf_rows, pred_rows), "UDFPredictor's rows differ from Predictor's")
    check(np.array_equal(classes, fitted.predict(X)),
          "UDF classes differ from DLClassifierModel.predict")
    only_kernels(all_kernel_counts(), {}, "DLClassifier / UDFPredictor")
    part = {"config": {"model": "WideDeep.from_spec(FeatureSpec(), "
                                f"embed_dim={WD_EMBED}, hidden="
                                f"{list(WD_HIDDEN)})",
                       "records": WD_RECORDS, "batch": WD_BATCH,
                       "input_dim": spec.input_dim, "dtype": "float32",
                       "criterion": "ClassNLLCriterion",
                       "method": f"SGD({WD_LR})", "tf32": tf32},
            **run, "records_per_s": rate, "host_leg": host,
            "dl_classifier": {"fit_s": fit_s, "epochs": 1,
                              "score": fitted.score(X, y),
                              "udf_rows_equal_predictor": True}}
    return part


def graph_tick_device_ms(model, cache_len):
    """The device time of one decode tick's CUDA graph (all slots) on
    caches of ``cache_len``, replayed back to back."""
    S = DECODE_SLOTS
    with torch.inference_mode():
        eng = DecodeEngine(model, slots=S, page=DECODE_PAGE)
        with eng._on_device():
            eng._ensure_cache(cache_len, idle=True)
            rng = np.random.default_rng(SEED + 13)
            tp = np.stack([rng.integers(0, LM["vocab_size"], S),
                           rng.integers(0, cache_len, S)]).astype(np.int32)
            for _ in range(3):
                eng._step_all(tp)
            graph = eng._graphs[("tick", cache_len)].graph
            return cuda_ms(graph.replay, iters=50)


def weight_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def zd_int8_lm():
    """(d) quantize(TransformerLM) at the serve width: scoring through
    InferenceServer on B6, decoding through DecodeEngine's graphs on B8;
    returns (the part, the kernels line's rows)."""
    from bigdl_torch.quantize import QuantMultiHeadAttention, quantize
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    model = TransformerLM(**LM).build(
        "cuda", torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    qmodel = quantize(model)
    quant_s = time.perf_counter() - t0
    check(sum(isinstance(m, QuantMultiHeadAttention)
              for m in qmodel.modules()) == LM["num_layers"],
          "the int8 LM's attention blocks")
    fbytes, qbytes = weight_bytes(model), weight_bytes(qmodel)
    # scoring
    rs = np.random.RandomState(SEED + 11)
    lengths = np.linspace(1, LM["max_len"], N_REQUESTS).astype(int)
    xs = [rs.randint(0, LM["vocab_size"], (n,)).astype(np.int64)
          for n in lengths]
    zero_all_kernels()
    server = InferenceServer(qmodel, seq_buckets=SEQ_BUCKETS,
                             max_batch=MAX_BATCH, max_wait_ms=5,
                             example=np.zeros((SEQ_BUCKETS[0],), np.int64))
    server.start()
    t1 = time.perf_counter()
    handles = [server.submit(x) for x in xs]
    outs = [h.result(300) for h in handles]
    wall = time.perf_counter() - t1
    server.stop()
    stats = server.stats()
    batches = stats["batches"] + stats["warmup_batches"]
    serve_launches = attn_ops.flash_attention.launches
    serve_routes = dict(attn_ops.flash_attention.route_launches)
    only_kernels(all_kernel_counts(),
                 {"flash_attention": LM["num_layers"] * batches},
                 "int8 LM scoring")
    check(only_route(attn_ops.flash_attention, "tc", serve_launches),
          f"int8 LM scoring routes {serve_routes}")
    predictor = Predictor(qmodel)
    worst = 0.0
    for x, out in zip(xs, outs):
        seq = fit_bucket(len(x), SEQ_BUCKETS)
        check(out.shape == (seq, LM["vocab_size"]) and np.isfinite(
            out).all(), f"int8 answer {out.shape} for length {len(x)}")
        ref = predictor.predict(pad_tail(x, seq)[None, :])[0]
        worst = max(worst, float(np.abs(out - ref).max()))
    check(worst <= SERVE_ATOL, f"int8 served vs Predictor: {worst}")
    lat = np.array([h.latency_s for h in handles]) * 1e3
    # decoding: the int8 engine, then the float one on the same work
    work = decode_workload(LM["vocab_size"])
    positions = sum(len(p) for p, _ in work)
    budget = sum(n for _, n in work)
    engines = {}
    for name, m in (("int8", qmodel), ("float", model)):
        both = run_engine(m, work, "continuous", slots=DECODE_SLOTS,
                          page=DECODE_PAGE)
        for run, r in both.items():
            d = r["delta"]
            what = f"{name} LM decode ({run})"
            check(d["seqs_done"] == len(work) and d["seqs_failed"] == 0
                  and d["tokens_out"] == budget, f"{what}: {d}")
            want = LM["num_layers"] * (positions + d["decode_steps"])
            check(r["launches"] == want and r["routes"] == {
                "bf16": want, "f32": 0},
                f"{what}: B8 {r['launches']} {r['routes']} != {want}")
        check(both["warm"]["delta"]["graph_captures"] == 0 and all(
            np.array_equal(a, b) for a, b in zip(both["cold"]["outs"],
                                                 both["warm"]["outs"])),
            f"{name} LM decode: warm run captured or differs")
        warm = both["warm"]
        engines[name] = {
            "outs": warm["outs"], "launches": warm["launches"],
            "routes": warm["routes"], "cache_len": warm["stats"]["cache_len"],
            "wall_s": warm["wall"], "tokens_per_s_wall": budget / warm["wall"],
            "decode_ticks": warm["delta"]["decode_steps"],
            "ttlt_p50_ms": float(np.percentile(warm["ttlt"], 50)),
            "ttlt_p99_ms": float(np.percentile(warm["ttlt"], 99)),
            "max_memory_allocated": warm["peak"]}
    agree, gaps = [], []
    for k, (p, n) in enumerate(work):
        oracle = cached_generate(qmodel, p, n, len(p) + n)
        i, gap = tie_rule(qmodel, engines["int8"]["outs"][k], oracle,
                          len(p), TIE_TOL[torch.bfloat16])
        agree.append(i - len(p))
        if gap is not None:
            gaps.append(gap)
    for name, m in (("int8", qmodel), ("float", model)):
        del engines[name]["outs"]
        engines[name]["graph_tick_device_ms"] = graph_tick_device_ms(
            m, engines["int8"]["cache_len"])
    # B6 at scoring's largest call and B8 at the engine's, int8 weights
    # in front of both (the kernels see the same operands' shapes)
    gen = torch.Generator().manual_seed(SEED + 12)
    H, D = LM["num_heads"], LM["d_model"] // LM["num_heads"]
    b6 = flash_case(MAX_BATCH, H, LM["max_len"], LM["max_len"], D,
                    torch.bfloat16, True, gen)
    b8 = decode_case(DECODE_SLOTS, H, engines["int8"]["cache_len"], D,
                     torch.bfloat16, gen)
    check(b6["ok"] and b8["ok"], f"B6 / B8 under the int8 LM: {b6} {b8}")
    del model, qmodel, predictor
    torch.cuda.empty_cache()
    part = {"config": {**LM, "quantized": "int8 weights, per-channel "
                       "scales; bf16 compute"},
            "quantize_s": quant_s, "weight_bytes": qbytes,
            "float_weight_bytes": fbytes, "bytes_ratio": qbytes / fbytes,
            "serve": {"requests": N_REQUESTS, "wall_s": wall,
                      "requests_per_s": N_REQUESTS / wall,
                      "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)),
                      "batches": stats["batches"],
                      "warmup_batches": stats["warmup_batches"],
                      "flash_launches": serve_launches,
                      "flash_route_launches": serve_routes,
                      "max_abs_err_vs_predictor": worst,
                      "tol": SERVE_ATOL},
            "decode": {"sequences": len(work), "token_budget": budget,
                       "prompt_positions": positions, **engines,
                       "agreeing_tokens": agree, "tie_gaps": gaps,
                       "tie_tol": TIE_TOL[torch.bfloat16]},
            "cases": {"b6": b6, "b8": b8}}
    rows = [kernel_row(b6, "flash_attention", *B6_SRC, serve_launches,
                       "zoo_data int8 serve", serve_routes),
            {**kernel_row(b8, "decode_attention",
                          *B8_SRC, engines["int8"]["launches"],
                          "zoo_data int8 decode", engines["int8"]["routes"]),
             "floor_ms": b8["floor_ms"], "splits": b8["splits"]}]
    return part, rows


class GrayToSample(Transformer):
    """A LabeledImage of three equal channels -> a one-channel Sample in
    [0, 1] with its int32 label."""

    def __call__(self, it):
        for img in it:
            yield Sample(img.data[..., :1] / 255.0, np.int32(img.label))


def zd_seqfile(root):
    """(e) SequenceFile shards streamed into LeNet-5 on the card."""
    from bigdl_torch.dataset import seqfile
    set_policy(DTypePolicy())
    folder = os.path.join(root, "seq")
    os.makedirs(folder)
    rs = np.random.default_rng(SEED + 14)
    for k in range(SEQ_SHARDS):
        gray = rs.integers(0, 256, (SEQ_PER_SHARD, 28, 28), dtype=np.uint8)
        seqfile.write_seq_file(
            os.path.join(folder, f"part-{k:05d}.seq"),
            [(f"img{k}_{i}", i % 10, np.repeat(gray[i][..., None], 3, 2))
             for i in range(SEQ_PER_SHARD)])
    ds = DataSet.seq_file_folder(folder)
    check(ds.size() == SEQ_SHARDS * SEQ_PER_SHARD, f"seq records {ds.size()}")
    model = LeNet5(10).build("cuda", torch.Generator().manual_seed(SEED))
    zero_all_kernels()
    with logged_losses() as log:
        t0 = time.perf_counter()
        opt = Optimizer(model, ds.transform(GrayToSample()),
                        nn.ClassNLLCriterion(), batch_size=SEQ_BATCH)
        opt.set_optim_method(SGD(0.05))
        opt.set_end_when(Trigger.max_iteration(SEQ_STEPS))
        opt.optimize()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    check(len(log.values) == SEQ_STEPS and all(map(math.isfinite,
                                                   log.values)),
          f"LeNet-5 from SequenceFile shards: losses {log.values}")
    only_kernels(all_kernel_counts(), {}, "LeNet-5 from SequenceFile")
    return {"shards": SEQ_SHARDS, "records": ds.size(),
            "bytes": sum(os.path.getsize(p) for p in
                         seqfile.find_seq_files(folder)),
            "steps": SEQ_STEPS, "batch": SEQ_BATCH, "losses": log.values,
            "seconds": seconds}


def zd_perf_cli(rates):
    """(e) ``python -m bigdl_torch.tools.perf`` on the card, each model in
    its own process; beside the same model's rate from an earlier phase
    of this run, where it ran."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    out = {}
    for name in PERF_MODELS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "bigdl_torch.tools.perf", "--model", name,
             "--batch-size", str(PERF_BATCH), "--iters", str(PERF_ITERS)],
            capture_output=True, text=True, timeout=PERF_TIMEOUT, cwd=here,
            env=env)
        check(proc.returncode == 0, f"perf --model {name}: "
              f"{proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        check(res["records_per_second"] > 0 and math.isfinite(
            res["timing"]["last_loss"]), f"perf --model {name}: {res}")
        out[name] = {**res, "process_s": time.perf_counter() - t0,
                     "earlier_phase": rates.get(name)}
    return out


def phase_zoo_data(rates=None):
    """The zoo's last models and the data half on the card (module
    docstring, 19); returns the kernels line's rows."""
    t0 = time.perf_counter()
    vit, rows = zd_vit()
    emit({"phase": "zoo_data", "part": "vit", "gpu": gpu_line(), **vit})
    with tempfile.TemporaryDirectory() as root:
        cli, cli_rows = zd_vit_cli(root)
        rows += cli_rows
        emit({"phase": "zoo_data", "part": "vit_cli", "gpu": gpu_line(),
              **cli})
        wd = zd_widedeep()
        emit({"phase": "zoo_data", "part": "widedeep", "gpu": gpu_line(),
              **wd})
        lm, lm_rows = zd_int8_lm()
        rows += lm_rows
        emit({"phase": "zoo_data", "part": "int8_lm", "gpu": gpu_line(),
              **lm})
        seq = zd_seqfile(root)
        perf = zd_perf_cli(rates or {})
        emit({"phase": "zoo_data", "part": "seqfile_perf",
              "gpu": gpu_line(), "seqfile": seq, "perf": perf})
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    emit({"phase": "zoo_data", "gpu": gpu_line(),
          "vit": {k: vit[k] for k in ("median_step_ms", "images_per_s",
                                      "max_memory_allocated")},
          "vit_idle_share": vit["profile"].get("device_idle_share"),
          "vit_busy_ms_per_step": vit["profile"].get(
              "device_busy_ms_per_step"),
          "vit_launches_per_step": vit["profile"].get("launches_per_step"),
          "vit_host_leg_max_abs_diff": vit["host_leg"]["max_abs_diff"],
          "widedeep": {k: wd[k] for k in ("median_step_ms", "records_per_s",
                                          "max_memory_allocated")},
          "widedeep_host_leg_max_abs_diff": wd["host_leg"]["max_abs_diff"],
          "int8_bytes_ratio": lm["bytes_ratio"],
          "int8_tokens_per_s": lm["decode"]["int8"]["tokens_per_s_wall"],
          "float_tokens_per_s": lm["decode"]["float"]["tokens_per_s_wall"],
          "int8_graph_tick_device_ms":
              lm["decode"]["int8"]["graph_tick_device_ms"],
          "float_graph_tick_device_ms":
              lm["decode"]["float"]["graph_tick_device_ms"],
          "perf_images_per_s": {k: v["records_per_second"]
                                for k, v in perf.items()},
          "wall_s": time.perf_counter() - t0})
    return rows


# -- 20. serve_stack ---------------------------------------------------------

#: the publishing trainer: B6 with its log-sum-exp and B7 at [16, 8, 512, 64]
SS_TRAIN_STEPS = 2
#: canary: a quarter of the batches, promoted after 4 clean ones of each arm;
#: a p99 ratio of 3 (the default is 2): four batches a side make a noisy p99
SS_CANARY = 0.25
SS_CANARY_MIN = 4
SS_LATENCY_RATIO = 3.0
#: requests a traffic round submits at once (one full device batch)
SS_ROUND = 8
#: the scoring rows of the first sequence bucket (ss_rows)
SS_ROWS = 16
SS_BURST = 96
SS_QUEUE_LIMIT = 256
SS_DEADLINE_MS = 10_000
#: the monitor's silence deadline and restart backoff, seconds
SS_REPLICA_LOST = 2.0
SS_BACKOFF = 0.05
#: autoscaling windows, shortened by the constructor's arguments
SS_AUTOSCALE = dict(autoscale_max=2, autoscale_target_wait_ms=100.0,
                    autoscale_up_polls=1, autoscale_idle_s=1.0,
                    autoscale_cooldown_s=0.2, autoscale_poll_s=0.02)
SS_TENANT_QPS = 10_000.0
SS_REPLAY_SPEED = 10.0
SS_GEN_TOKENS = 32
#: serving_bench's tokens a sequence (its default)
SS_BENCH_TOKENS = 32
SS_WAIT_S = 60.0
SS_CLI_TIMEOUT = 300
#: the phase's device (its CPU rehearsal sets "cpu")
SS_DEVICE = "cuda"


def ss_sync():
    if SS_DEVICE == "cuda":
        torch.cuda.synchronize()


class ScoreBook:
    """Every scoring request of the phase, held to ``Predictor`` on the
    weights of the version that answered it (``handle.version``), within
    ``SERVE_ATOL``.  ``extra_forwards`` counts the forwards made outside
    the server (each launches B6 once a layer)."""

    def __init__(self, rows, predictors):
        self.rows = rows
        self.index = {r.tobytes(): i for i, r in enumerate(rows)}
        self.pred = predictors          # weights name -> Predictor
        self.weights = {1: "initial"}   # version id -> weights name
        self.refs = {}
        self.extra_forwards = 0
        self.worst = 0.0
        self.outcomes = collections.Counter()
        self.pending = []
        self.lock = threading.Lock()

    def ref(self, name, i):
        if (name, i) not in self.refs:
            x = self.rows[i]
            seq = fit_bucket(len(x), SEQ_BUCKETS)
            self.refs[(name, i)] = self.pred[name].predict(
                pad_tail(x, seq)[None, :])[0]
            self.extra_forwards += 1
        return self.refs[(name, i)]

    def submit(self, server, i, **kw):
        h = server.submit(self.rows[i], **kw)
        with self.lock:
            self.pending.append((i, h))
        return h

    def settle(self):
        """Wait out every pending request and check it: an answer against
        its version's weights, a canary batch's fault counted; anything
        else (a timeout: a request lost) fails the phase."""
        with self.lock:
            pending, self.pending = self.pending, []
        lat = []
        for i, h in pending:
            try:
                out = h.result(SS_WAIT_S)
            except chaos.ChaosFault:
                self.outcomes["canary_fault"] += 1
                continue
            seq = fit_bucket(len(self.rows[i]), SEQ_BUCKETS)
            check(out.shape == (seq, LM["vocab_size"])
                  and np.isfinite(out).all(),
                  f"serve_stack answer {out.shape} for row {i}")
            ref = self.ref(self.weights[h.version], i)
            self.worst = max(self.worst, float(np.abs(out - ref).max()))
            self.outcomes[f"v{h.version}"] += 1
            lat.append(h.latency_s)
        return lat


def ss_rows(vocab):
    """SS_ROWS rows in the first sequence bucket's top fifth, then one in
    the middle and one at the edge of each longer bucket."""
    rng = np.random.default_rng(SEED + 20)
    b = SEQ_BUCKETS
    lengths = [int(n) for n in rng.integers(b[0] * 4 // 5, b[0] + 1,
                                            SS_ROWS)]
    for lo, hi in zip(b, b[1:]):
        lengths += [(lo + hi) // 2, hi]
    return [rng.integers(0, vocab, n).astype(np.int64) for n in lengths]


def ss_traffic(server, book, stop, errors):
    """Rounds of SS_ROUND requests at the first sequence bucket (two
    tenants) until ``stop`` is set; each round waits for its answers and
    has them checked (so no answer is kept longer than its round)."""
    k = 0
    try:
        while not stop.is_set():
            hs = [book.submit(server, (k + j) % SS_ROWS,
                              tenant="ab"[(k + j) % 2],
                              deadline_ms=SS_DEADLINE_MS)
                  for j in range(SS_ROUND)]
            k += SS_ROUND
            book.settle()
    except BaseException as e:  # noqa: BLE001 - raised again by the caller
        errors.append(e)


def ss_until(pred, what, timeout=SS_WAIT_S):
    deadline = time.perf_counter() + timeout
    while not pred():
        check(time.perf_counter() < deadline, f"serve_stack: {what} not "
              f"reached in {timeout} s")
        time.sleep(0.01)


def ss_with_traffic(server, book, until, what):
    stop, errors = threading.Event(), []
    t = threading.Thread(target=ss_traffic,
                         args=(server, book, stop, errors), daemon=True)
    t.start()
    try:
        ss_until(lambda: errors or until(), what)
    finally:
        stop.set()
        t.join(SS_WAIT_S)
    if errors:
        raise errors[0]
    check(not t.is_alive(), f"serve_stack: traffic of {what} did not stop")


def ss_trainer(ckdir, vocab):
    """(a) a second copy of the LM trained SS_TRAIN_STEPS steps through
    the Optimizer, which publishes its snapshot as release 1."""
    model = TransformerLM(**LM).build(
        SS_DEVICE, torch.Generator().manual_seed(SEED))
    samples = lm_samples(LM_BATCH * SS_TRAIN_STEPS, LM["max_len"], vocab,
                         SEED + 21)
    opt = Optimizer(model, DataSet.array(samples, seed=SEED),
                    nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                                size_average=True),
                    batch_size=LM_BATCH, device=SS_DEVICE)
    opt.set_optim_method(SGD(LM_LR, momentum=0.9))
    opt.set_checkpoint(ckdir, every_done(SS_TRAIN_STEPS), publish=True)
    opt.set_end_when(Trigger(lambda s: s["neval"] > SS_TRAIN_STEPS,
                             "steps"))
    t0 = time.perf_counter()
    opt.optimize()
    ss_sync()
    seconds = time.perf_counter() - t0
    check(opt._publisher is not None and opt._publisher.published == 1,
          "serve_stack: the trainer published no release")
    del model, opt
    return seconds


def ss_load(path):
    """The LM with a snapshot's weights, loaded apart from the server."""
    blob = file_io.load(path)
    model = TransformerLM(**LM).build(
        SS_DEVICE, torch.Generator().manual_seed(SEED))
    return load_reference_tree(model, blob["params"], blob["state"])


def ss_timeline(ctl):
    return [{k: v for k, v in e.items() if k != "time"}
            for e in ctl.versions()["timeline"]]


def ss_deploy(server, book, root):
    """(a) the trainer's release canaried and promoted; a rewritten
    snapshot refused; a canary that ``serve.canary`` faults rolled back; a
    plain swap timed to its first answer."""
    ckdir = os.path.join(root, "ckpt")
    train_s = ss_trainer(ckdir, LM["vocab_size"])
    trained = tct.read_release(os.path.join(ckdir, "release.1"))
    book.pred["trained"] = Predictor(ss_load(trained["model_path"]),
                                     device=SS_DEVICE)
    book.weights.update({2: "trained", 3: "trained", 4: "trained"})
    for name in ("initial", "trained"):   # off the traffic's pace
        for i in range(len(book.rows)):
            book.ref(name, i)
    ctl = tct.DeployController(server, ckdir, canary_fraction=SS_CANARY,
                               poll_s=0.02).start()
    try:
        ss_with_traffic(server, book,
                        lambda: ctl.stats()["promoted"]
                        + ctl.stats()["rolled_back"] >= 1,
                        "the canary's verdict")
    finally:
        ctl.stop()
    canary1 = server.stats()["canary"]
    check(ctl.stats()["promoted"] == 1 and server.version.id == 2,
          f"serve_stack: release 1 not promoted: {canary1}")
    first = ss_timeline(ctl)
    times = {e["action"]: e["time"] for e in ctl.versions()["timeline"]}
    canary_s = times["promoted"] - times["deployed"]
    book.settle()
    # after the promotion: a lone request equals the promoted version's
    # own forward of the same [1, 128] batch bit for bit
    bit_equal = True
    for i in range(3):
        x = book.rows[i]
        h = server.submit(x)
        out = h.result(SS_WAIT_S)
        own = server.version.predict(pad_tail(x, SEQ_BUCKETS[0])[None])[0]
        book.extra_forwards += 1
        bit_equal &= h.version == 2 and np.array_equal(
            out.view(np.uint32), own.view(np.uint32))
    check(bit_equal, "serve_stack: rows after the promotion differ from "
          "the promoted version's forward")
    # release 2: a snapshot rewritten after publication; release 3: a good
    # snapshot whose canary batches fault
    extra = os.path.join(root, "extra")
    os.makedirs(extra)
    good = os.path.join(extra, "good")
    rewritten = os.path.join(extra, "rewritten")
    shutil.copyfile(trained["model_path"], good)
    shutil.copyfile(trained["model_path"], rewritten)
    pub = tct.ReleasePublisher(ckdir)
    pub.publish(rewritten, neval=100)
    blob = file_io.load(rewritten)
    blob["rewritten"] = True
    file_io.save(blob, rewritten)
    pub.publish(good, neval=101)
    spec = "serve.canary=fail@" + ",".join(str(i) for i in range(1, 17))
    with chaos.scoped(spec):
        ctl2 = tct.DeployController(server, ckdir, since=1,
                                    canary_fraction=SS_CANARY,
                                    poll_s=0.02).start()
        try:
            ss_with_traffic(server, book,
                            lambda: ctl2.stats()["promoted"]
                            + ctl2.stats()["rolled_back"] >= 1,
                            "the faulted canary's verdict")
        finally:
            ctl2.stop()
    book.settle()
    check(book.outcomes["canary_fault"] >= 1,
          "serve_stack: no canary batch faulted")
    second = ss_timeline(ctl2)
    rejected = [e for e in second if e["action"] == "rejected"]
    rolled = [e for e in second if e["action"] == "rolled_back"]
    check(server.version.id == 2 and len(rejected) == 1
          and rejected[0]["release"] == 2
          and "fingerprint" in rejected[0]["reason"] and len(rolled) == 1
          and rolled[0]["release"] == 3
          and rolled[0]["verdict"]["reason_type"] == "CanaryRejected",
          f"serve_stack: refused releases {second}")
    check(os.path.exists(os.path.join(ckdir, "release.2.corrupt")),
          "serve_stack: the rewritten release was not quarantined")
    # a plain swap, from its call to the first answer of the new version
    t0 = time.perf_counter()
    vid = server.swap(good)
    h = book.submit(server, 0)
    h.result(SS_WAIT_S)
    swap_ms = (time.perf_counter() - t0) * 1e3
    check(vid == 4 and h.version == 4, f"serve_stack: swap {vid}, answer "
          f"from {h.version}")
    book.settle()
    return {"train_s": train_s, "release_1": {
        k: trained[k] for k in ("release_id", "epoch", "iteration", "neval",
                                "model_name")},
        "canary_decision_s": canary_s, "canary_promoted": canary1,
        "canary_rolled_back": server.stats()["canary"],
        "promoted_rows_bit_equal": bit_equal, "timeline_1": first,
        "timeline_2": second, "swap_to_first_answer_ms": swap_ms,
        "swapped_version": vid}


def ss_restart(server, book):
    """(b) replica 0 killed by its fault point: restarted by the monitor,
    every admitted request answered.  The autoscaler stays on: when the
    dead replica's batch outwaits its target it adds a replica, which may
    answer before the monitor's restart (a forward rebuilt and warmed) is
    counted, so the restart is waited for before it is checked, and the
    pool for its shrink back to one."""
    server.scale_to(1)
    ss_until(lambda: server.stats()["replicas_live"] == 1, "one replica")
    before = server.stats()
    with chaos.scoped("serve.replica@0=exit@1"):
        t0 = time.perf_counter()
        hs = [book.submit(server, i) for i in range(SS_ROUND)]
        for h in hs:
            h.result(SS_WAIT_S)
        restart_ms = (time.perf_counter() - t0) * 1e3
    book.settle()
    ss_until(lambda: server.stats()["restarts"] > before["restarts"],
             "the monitor's restart")
    st = server.stats()
    check(st["restarts"] - before["restarts"] == 1 and server.healthy()
          and st["replica_monitor"]["lost"] == 1
          and st["restarts"] <= st["replica_monitor"]["budget"],
          f"serve_stack: restart {st['replica_monitor']}")
    ss_until(lambda: server.stats()["replicas"] == 1, "the pool at one", 15)
    return {"restart_ms": restart_ms, "monitor": st["replica_monitor"]}


def ss_budget():
    """(b) a second small server (LeNet-5 on the card, budget 1): two
    kills spend the budget and ``healthy()`` turns False."""
    model = LeNet5(10).build(SS_DEVICE,
                             torch.Generator().manual_seed(SEED))
    server = InferenceServer(model, example=np.zeros((28, 28, 1),
                                                     np.float32),
                             device=SS_DEVICE, max_batch=1, replica_lost=0.2,
                             restart_budget=1, restart_backoff=0.01)
    with server, chaos.scoped("serve.replica@0=exit@1,2"):
        h = server.submit(np.zeros((28, 28, 1), np.float32))
        ss_until(lambda: not server.healthy(), "the spent budget", 10)
        lost = False
        try:
            h.result(SS_WAIT_S)
        except ReplicaLostError:
            lost = True
        st = server.stats()
    check(lost and st["unhealthy_type"] == "ReplicaLostError",
          f"serve_stack: the spent budget {st}")
    return {"healthy": False, "restarts": st["restarts"],
            "unhealthy_reason": st["unhealthy_reason"]}


def ss_autoscale(server, book):
    """(c) a burst grows the pool 1 -> 2, idling shrinks it back."""
    check(server.stats()["replicas"] == 1, "serve_stack: pool not at 1")
    t0 = time.perf_counter()
    hs = [book.submit(server, i % SS_ROWS, tenant="burst",
                      deadline_ms=SS_DEADLINE_MS) for i in range(SS_BURST)]
    up_ms = None
    while not all(h.done() for h in hs):
        if up_ms is None and server.stats()["replicas"] == 2:
            up_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.005)
    t1 = time.perf_counter()
    burst_s = t1 - t0
    check(up_ms is not None, "serve_stack: the burst did not grow the pool")
    ss_until(lambda: server.stats()["replicas"] == 1, "the shrink", 15)
    down_s = time.perf_counter() - t1
    lat = book.settle()
    st = server.stats()["autoscale"]
    check(st["scale_ups"] >= 1 and st["scale_downs"] >= 1,
          f"serve_stack: autoscale {st}")
    return {"burst": SS_BURST, "scale_up_ms": up_ms, "burst_s": burst_s,
            "burst_p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "idle_to_shrink_s": down_s, "autoscale": st}


def ss_workload(server, book):
    """Every row twice at once: requests/s and latency p50 and p99."""
    t0 = time.perf_counter()
    hs = [book.submit(server, i % len(book.rows))
          for i in range(2 * len(book.rows))]
    for h in hs:
        h.result(SS_WAIT_S)
    wall = time.perf_counter() - t0
    lat = np.array(book.settle()) * 1e3
    return {"requests": len(hs), "requests_per_s": len(hs) / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def ss_trace(server, book, root, path):
    """(d) the offered traffic replayed at SS_REPLAY_SPEED x, per-tenant
    SLO attainment; scoring with the tracer off and on, its Chrome trace
    and the metrics registry."""
    recorded = len(server.stop_trace())
    header, events = tracefile.read_trace(path)
    check(header["count"] == recorded > 0, "serve_stack: the trace file")

    def submit(e):
        return book.submit(server, book.index[np.asarray(
            e.payload).tobytes()], tenant=e.tenant, priority=e.priority,
            deadline_ms=e.deadline_ms)
    t0 = time.perf_counter()
    outs = tracefile.replay(events, submit, speed=SS_REPLAY_SPEED)
    tracefile.resolve_outcomes(outs, timeout=SS_WAIT_S)
    replay_s = time.perf_counter() - t0
    slo = tracefile.slo_report(outs)
    book.settle()
    check(slo["offered"] == len(events) and slo["shed"]["errors"] == 0,
          f"serve_stack: replay {slo}")
    off = ss_workload(server, book)
    tdir = os.path.join(root, "trace")
    tracer = telemetry.Tracer(tdir, flush_every=0)
    telemetry.set_active(tracer)
    reg = metrics_export.arm()
    on = ss_workload(server, book)
    tracer.flush()
    merged = telemetry.merge_traces(tdir)
    phases = telemetry.phase_breakdown(merged)
    flows = telemetry.request_breakdown(merged)
    check("serve.batch" in phases["phases"] and flows["count"] ==
          on["requests"], f"serve_stack: the trace holds "
          f"{list(phases['phases'])} and {flows['count']} request flows")
    return {"recorded": recorded, "recorded_s": header["duration_s"],
            "replay_speed": SS_REPLAY_SPEED, "replay_s": replay_s,
            "slo": slo, "tracer_off": off, "tracer_on": on,
            "trace_events": len(merged["traceEvents"]),
            "serve_batch": phases["phases"]["serve.batch"],
            "request_segments_ms": {k: v["p50_ms"] for k, v in
                                    flows["segments"].items()}}, tracer, reg


def ss_post(base, path, obj=None, headers=None):
    import urllib.request
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {},
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=SS_WAIT_S) as r:
        body = r.read()
        code, ctype = r.status, r.headers.get("Content-Type", "")
    check(code == 200, f"serve_stack: {path} answered {code}")
    return json.loads(body) if "json" in ctype else body.decode()


def ss_generate_http(base, prompts, trace):
    """8 prompts through POST /v1/generate from 8 threads, recorded."""
    out = [None] * len(prompts)
    errs = []

    def one(k):
        try:
            out[k] = ss_post(base, "/v1/generate", {
                "prompt": prompts[k].tolist(), "max_tokens": SS_GEN_TOKENS,
                "tenant": "gen"}, {"X-BigDL-Record-Trace": trace})
        except Exception as e:  # noqa: BLE001 - failed below
            errs.append(repr(e))
    threads = [threading.Thread(target=one, args=(k,))
               for k in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SS_WAIT_S)
    wall = time.perf_counter() - t0
    check(not errs and all(o is not None for o in out),
          f"serve_stack: /v1/generate {errs}")
    return out, wall


def ss_engine_run(eng, prompts):
    t0 = time.perf_counter()
    hs = [eng.submit(p, SS_GEN_TOKENS) for p in prompts]
    rows = [h.result(SS_WAIT_S) for h in hs]
    return rows, time.perf_counter() - t0, [h.latency_s * 1e3 for h in hs]


def ss_http(server, lm, root):
    """(e) the HTTP front over the scoring server, a DecodeEngine of the
    same LM behind /v1/generate; the other routes and the record header."""
    rng = np.random.default_rng(SEED + 22)
    prompts = [rng.integers(0, LM["vocab_size"], int(n)).astype(np.int32)
               for n in rng.integers(8, min(65, LM["max_len"] -
                                            SS_GEN_TOKENS + 1),
                                     DECODE_SLOTS)]
    positions = sum(len(p) for p in prompts)
    budget = SS_GEN_TOKENS * len(prompts)
    eng = DecodeEngine(lm, slots=DECODE_SLOTS, page=DECODE_PAGE,
                       device=SS_DEVICE).start()
    server.decode_engine = eng
    httpd = serve_http.serve_forever(server, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    trace = os.path.join(root, "generate.trace")
    fn = dec_ops.decode_attention
    try:
        cold, _, _ = ss_engine_run(eng, prompts)   # captures the graphs
        # one request arms the recording (concurrent first arms would race
        # to install their own recorder)
        ss_post(base, "/v1/generate", {"prompt": [1], "max_tokens": 1},
                {"X-BigDL-Record-Trace": trace})
        before = eng.stats()
        fn.launches = 0
        zero_routes(fn)
        zero_flash()
        answers, wall = ss_generate_http(base, prompts, trace)
        after = eng.stats()
        launches, routes = fn.launches, dict(fn.route_launches)
        ticks = after["decode_steps"] - before["decode_steps"]
        ss_check_b8(launches, routes, positions, ticks, before, after)
        ss_post(base, "/v1/generate", {"prompt": [1], "max_tokens": 1},
                {"X-BigDL-Record-Trace": "off"})
        warm, warm_wall, warm_ttlt = ss_engine_run(eng, prompts)
        routes_200 = {}
        for path in ("/healthz", "/v1/stats", "/v1/versions", "/metrics"):
            routes_200[path] = ss_post(base, path)
        st, versions = routes_200["/v1/stats"], routes_200["/v1/versions"]
        parsed = metrics_export.parse_exposition(routes_200["/metrics"])
        check(routes_200["/healthz"]["ok"] and "decode" in st
              and st["deploy"]["rolled_back"] == 1 and versions["deploy"]
              and "bigdl_serve_requests_total" in parsed
              and "bigdl_decode_ttlt_seconds" in parsed,
              f"serve_stack: the GET routes {sorted(st)} {sorted(parsed)}")
        _, recorded = tracefile.read_trace(trace)
        check(len(recorded) == 1 + len(prompts) and all(
            e.gen["max_tokens"] == SS_GEN_TOKENS for e in recorded[1:]),
            f"serve_stack: the generate trace holds {len(recorded)}")
    finally:
        httpd.shutdown()
        eng.stop()
        server.decode_engine = None
    rows = [np.asarray(a["tokens"], np.int32) for a in answers]
    check(all(np.array_equal(r, w) for r, w in zip(rows, warm))
          and all(np.array_equal(r, c) for r, c in zip(rows, cold)),
          "serve_stack: /v1/generate differs from the engine's rows")
    agree, gaps = [], []
    for p, r in zip(prompts, rows):
        oracle = cached_generate(lm, p, SS_GEN_TOKENS, len(p) +
                                 SS_GEN_TOKENS)
        i, gap = tie_rule(lm, r, oracle, len(p), TIE_TOL[torch.bfloat16])
        agree.append(i - len(p))
        if gap is not None:
            gaps.append(gap)
    ttlt = [a["latency_ms"] for a in answers]
    return {"prompts": len(prompts), "prompt_positions": positions,
            "tokens": budget, "http_tokens_per_s": budget / wall,
            "http_ttlt_p50_ms": float(np.percentile(ttlt, 50)),
            "http_ttlt_p99_ms": float(np.percentile(ttlt, 99)),
            "engine_tokens_per_s": budget / warm_wall,
            "engine_ttlt_p50_ms": float(np.percentile(warm_ttlt, 50)),
            "engine_ttlt_p99_ms": float(np.percentile(warm_ttlt, 99)),
            "decode_ticks": ticks, "b8_launches": launches,
            "b8_routes": routes, "cache_len": after["cache_len"],
            "agreeing_tokens": agree, "tie_gaps": gaps,
            "metrics_names": len(parsed), "timeline": versions["timeline"],
            "routes_200": sorted(routes_200)}


def ss_cli(root):
    """(f) ``python -m bigdl_torch.tools.serve_http --generate`` as a
    child: one predict, one generate (the tiny LM, D = 16), one swap to a
    LeNet-5 module file, then SIGTERM: it drains and exits 0; and
    ``python -m bigdl_torch.tools.serving_bench`` at the LM width."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    module = os.path.join(root, "lenet.module")
    LeNet5(10).build(SS_DEVICE, torch.Generator().manual_seed(SEED + 1)) \
        .save(module)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigdl_torch.tools.serve_http", "--model",
         "lenet", "--port", "0", "--generate", "--device", SS_DEVICE],
        cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        start = json.loads(proc.stdout.readline())
        base = start["serving"]
        ready_s = time.perf_counter() - t0
        x = np.random.default_rng(SEED).random((28, 28, 1)).tolist()
        pred = ss_post(base, "/v1/predict", {"inputs": x})
        gen = ss_post(base, "/v1/generate", {"prompt": [1, 2, 3],
                                             "max_tokens": 8})
        swap = ss_post(base, "/v1/swap", {"source": module})
        pred2 = ss_post(base, "/v1/predict", {"inputs": x})
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rest, err = proc.communicate(timeout=SS_CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            rest, err = proc.communicate()
    check(proc.returncode == 0, f"serve_http exited {proc.returncode}: "
          f"{err[-2000:]}")
    last = json.loads(rest.strip().splitlines()[-1])
    check(len(pred["outputs"]) == 10 and gen["generated"] == 8
          and swap == {"version": 2} and pred2["version"] == 2
          and last["stopped"] and last["stats"]["swaps"] == 1,
          f"serve_http child: {pred} {gen} {swap} {last}")
    t1 = time.perf_counter()
    bench = subprocess.run(
        [sys.executable, "-m", "bigdl_torch.tools.serving_bench",
         "--max-len", str(LM["max_len"]), "--d-model",
         str(LM["d_model"]), "--num-heads", str(LM["num_heads"]),
         "--num-layers", str(LM["num_layers"]), "--vocab",
         str(LM["vocab_size"]), "--num-tokens",
         str(min(SS_BENCH_TOKENS, LM["max_len"] - 1)), "--device",
         SS_DEVICE],
        capture_output=True, text=True,
        timeout=SS_CLI_TIMEOUT, cwd=here, env=env)
    check(bench.returncode == 0, f"serving_bench: {bench.stderr[-2000:]}")
    res = json.loads(bench.stdout.strip().splitlines()[-1])
    check([r["path"] for r in res["results"]] == ["full_fwd", "kv_cache",
                                                  "kv_int8"],
          f"serving_bench: {res}")
    return {"cli": {"ready_s": ready_s, "device": start["device"],
                    "generate_tokens": gen["tokens"],
                    "stopped": last, "process_s": t1 - t0},
            "serving_bench": {**res, "process_s": time.perf_counter() - t1}}


def phase_serve_stack():
    """The serving stack in one process on the card (module docstring,
    20); returns the kernels line's rows."""
    t_phase = time.perf_counter()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    lm = TransformerLM(**LM).build(
        SS_DEVICE, torch.Generator().manual_seed(SEED))
    book = ScoreBook(ss_rows(LM["vocab_size"]),
                     {"initial": Predictor(lm, device=SS_DEVICE)})
    zero_all_kernels()
    with tempfile.TemporaryDirectory() as root:
        server = InferenceServer(
            lm, seq_buckets=SEQ_BUCKETS, max_batch=MAX_BATCH, max_wait_ms=5,
            queue_limit=SS_QUEUE_LIMIT, replicas=1,
            example=np.zeros((SEQ_BUCKETS[0],), np.int64),
            replica_lost=SS_REPLICA_LOST, restart_budget=2,
            restart_backoff=SS_BACKOFF, canary_min_batches=SS_CANARY_MIN,
            canary_latency_ratio=SS_LATENCY_RATIO,
            tenant_qps=SS_TENANT_QPS, device=SS_DEVICE, **SS_AUTOSCALE)
        t0 = time.perf_counter()
        server.start()
        ss_sync()
        warm_s = time.perf_counter() - t0
        offered = os.path.join(root, "offered.trace")
        server.record_trace(offered)
        tracer = None
        try:
            deploy = ss_deploy(server, book, root)
            emit({"phase": "serve_stack", "part": "deploy",
                  "gpu": gpu_line(), "warmup_s": warm_s, **deploy})
            restart = ss_restart(server, book)
            restart["budget_server"] = ss_budget()
            emit({"phase": "serve_stack", "part": "restart",
                  "gpu": gpu_line(), **restart})
            scale = ss_autoscale(server, book)
            emit({"phase": "serve_stack", "part": "autoscale",
                  "gpu": gpu_line(), **scale})
            trace, tracer, _ = ss_trace(server, book, root, offered)
            emit({"phase": "serve_stack", "part": "trace",
                  "gpu": gpu_line(), **trace})
            # the scoring window closes
            st = server.stats()
            batches = st["batches"] + st["warmup_batches"]
            launched = ss_check_scoring(batches, book.extra_forwards)
            check(book.worst <= SERVE_ATOL,
                  f"serve_stack: answers vs Predictor {book.worst}")
            http = ss_http(server, lm, root)
            emit({"phase": "serve_stack", "part": "http",
                  "gpu": gpu_line(), **http})
        finally:
            if tracer is not None:
                tracer.close()
            metrics_export.disarm()
            server.stop()
        cli = ss_cli(root)
        emit({"phase": "serve_stack", "part": "cli", "gpu": gpu_line(),
              **cli})
    worst, outcomes = book.worst, dict(book.outcomes)
    del lm, book
    bench = {r["path"]: r["tokens_per_sec"]
             for r in cli["serving_bench"]["results"]}
    emit({"phase": "serve_stack", "gpu": gpu_line(),
          "device_batches": batches, **launched,
          "b8_http_launches": http["b8_launches"],
          "answers_max_abs_err_vs_predictor": worst, "tol": SERVE_ATOL,
          "answers_by_version": outcomes,
          "swap_to_first_answer_ms": deploy["swap_to_first_answer_ms"],
          "canary_decision_s": deploy["canary_decision_s"],
          "restart_ms": restart["restart_ms"],
          "scale_up_ms": scale["scale_up_ms"],
          "replay_attainment": trace["slo"]["attainment"],
          "replay_per_tenant": {t: b["attainment"] for t, b in
                                trace["slo"]["per_tenant"].items()},
          "scoring_tracer_off": trace["tracer_off"],
          "scoring_tracer_on": trace["tracer_on"],
          "http_tokens_per_s": http["http_tokens_per_s"],
          "http_ttlt_p50_ms": http["http_ttlt_p50_ms"],
          "http_ttlt_p99_ms": http["http_ttlt_p99_ms"],
          "engine_tokens_per_s": http["engine_tokens_per_s"],
          "engine_ttlt_p50_ms": http["engine_ttlt_p50_ms"],
          "engine_ttlt_p99_ms": http["engine_ttlt_p99_ms"],
          "serving_bench_tokens_per_s": bench,
          "wall_s": time.perf_counter() - t_phase})
    return ss_kernel_rows(launched, http)


def ss_check_scoring(batches, extra_forwards):
    """The scoring window's launches: every B6 launch is a device batch
    of the server (the warm-ups of every version included), a forward
    made beside it, or the trainer's (the ones writing the log-sum-exp);
    B7 is the trainer's; all on "tc"."""
    L = LM["num_layers"]
    fwd, bwd = flash_counts()
    lse = attn_ops.flash_attention.lse_launches
    routes = flash_routes()
    check(fwd - lse == L * (batches + extra_forwards)
          and lse == L * SS_TRAIN_STEPS and bwd == 2 * L * SS_TRAIN_STEPS
          and only_route(attn_ops.flash_attention, "tc", fwd)
          and only_route(attn_ops.flash_attention_bwd, "tc", bwd)
          and all_kernel_counts()["decode_attention"] == 0,
          f"serve_stack: B6 {fwd} ({lse} with the log-sum-exp), B7 {bwd}, "
          f"routes {routes}, {batches} device batches, {extra_forwards} "
          "forwards beside the server")
    return {"b6_serve_launches": fwd - lse, "b6_lse_launches": lse,
            "b7_launches": bwd, "routes": routes}


def ss_check_b8(launches, routes, positions, ticks, before, after):
    want = LM["num_layers"] * (positions + ticks)
    check(launches == want and routes == {"bf16": want, "f32": 0}
          and flash_counts() == (0, 0),
          f"serve_stack: /v1/generate B8 {launches} {routes} != {want}")
    check(after["graphs"]["captures"] == before["graphs"]["captures"],
          "serve_stack: /v1/generate captured a graph")


def ss_kernel_rows(launched, http):
    """B6 at the canary traffic's call and the trainer's, B7 at the
    trainer's, B8 at the engine's, each against its plain version and
    timed; the kernels line's rows."""
    gen = torch.Generator().manual_seed(SEED + 23)
    H, D = LM["num_heads"], LM["d_model"] // LM["num_heads"]
    b6 = flash_case(MAX_BATCH, H, SEQ_BUCKETS[0], SEQ_BUCKETS[0], D,
                    torch.bfloat16, True, gen)
    b6_lse = flash_case(LM_BATCH, H, LM["max_len"], LM["max_len"], D,
                        torch.bfloat16, True, gen, with_lse=True)
    b7 = b7_case(LM_BATCH, H, LM["max_len"], LM["max_len"], D,
                 torch.bfloat16, True,
                 torch.Generator(device="cuda").manual_seed(SEED + 23))
    b8 = decode_case(DECODE_SLOTS, H, http["cache_len"], D,
                     torch.bfloat16, gen)
    cases = {"b6": b6, "b6_lse": b6_lse, "b7": b7, "b8": b8}
    emit({"phase": "serve_stack", "part": "kernels", "gpu": gpu_line(),
          "cases": cases})
    check(all(c["ok"] for c in cases.values()),
          f"serve_stack: kernel cases {cases}")
    routes = launched["routes"]
    return [kernel_row(b6, "flash_attention", *B6_SRC,
                       launched["b6_serve_launches"], "serve_stack scoring",
                       routes["flash_attention"]),
            kernel_row(b6_lse, "flash_attention", *B6_SRC,
                       launched["b6_lse_launches"],
                       "serve_stack publishing trainer",
                       routes["flash_attention"]),
            kernel_row(b7, "flash_attention_bwd", *B7_SRC,
                       launched["b7_launches"],
                       "serve_stack publishing trainer",
                       routes["flash_attention_bwd"]),
            {**kernel_row(b8, "decode_attention", *B8_SRC,
                          http["b8_launches"], "serve_stack /v1/generate",
                          http["b8_routes"]),
             "floor_ms": b8["floor_ms"], "splits": b8["splits"]}]


# ---------------------------------------------------------------------------
# elastic_fleet: the bench LM trained elastically, the serving fleet
# ---------------------------------------------------------------------------

EF_BATCH = 16                  # per rank at world 2; 32 at world 1
EF_SAMPLES = 2 * EF_BATCH * 4  # 4 iterations an epoch at either world
EF_LR = 1e-3
EF_LOST_AT = "1:3"             # rank 1 exits at the top of iteration 3
EF_RETURN_AT = "2:2"           # the joiner's announcement gate
EF_PEER_LOST = 4.0             # seconds of publication silence
EF_AFTER_GROW = 3              # iterations trained after the grow
EF_MAX_ITERS = 60              # the cap of a run that never grows
EF_KEEP = 6                    # snapshots the drill keeps beyond its plans
EF_TIMEOUT = 600
EF_STEP = {"fwd": LM["num_layers"], "bwd": 2 * LM["num_layers"],
           "lse": LM["num_layers"]}
EF_FLEET = 3
EF_BEAT_S = 0.1
EF_LOST_AFTER_S = 1.0
EF_WEDGE_BEAT = 80             # member 1's first life wedges at beat 80
EF_REQUESTS = 400
EF_REQUEST_DT = 0.02
EF_KILL_AT_S = 1.5
EF_CANARY = 0.3
EF_LATENCY_N = 200
EF_FLEET_ENV = {"BIGDL_TORCH_SERVE_CANARY_MIN_BATCHES": "4",
                "BIGDL_TORCH_SERVE_CANARY_LATENCY_RATIO": "3.0"}
# a CPU rehearsal of the phase sets these to "cpu", a script of its own
# for the children and ("--device", "cpu") for the workers
EF_DEVICE = "cuda"
EF_SCRIPT = None
EF_WORKER_ARGS = ()


def ef_snapshot():
    """The B6 and B7 counters: launches, log-sum-exp launches, routes."""
    return (attn_ops.flash_attention.launches,
            attn_ops.flash_attention_bwd.launches,
            attn_ops.flash_attention.lse_launches,
            dict(attn_ops.flash_attention.route_launches),
            dict(attn_ops.flash_attention_bwd.route_launches))


class EfLog:
    """The elastic drill's harness around one Optimizer run, as its end
    trigger and its train summary.  Before each step a barrier over the
    shared dir holds the rank until every current survivor has finished
    the previous iteration: the wait a data-parallel step spends in its
    collective, without which the ranks (each training its own shard,
    nothing summed over the logical world) would drift apart and a rank
    that finished first would read as lost.  After each step: the loss,
    the step's milliseconds (the device synchronized), its B6 and B7
    launches, the world and batch.  The writer of a drilled run keeps the
    newest ``EF_KEEP`` snapshots and those its re-forms adopted.  A
    drilled run ends ``EF_AFTER_GROW`` iterations after its grow or join,
    a clean one at ``spec["end"]``."""

    def __init__(self, spec, opt):
        self.spec, self.opt = spec, opt
        self.records = []
        self._mark = None

    def end(self, state):
        n = state["neval"]
        if self.spec.get("barrier"):
            self._barrier(n - 1)
        if self.spec.get("prune") and Engine.is_writer():
            file_io.prune_checkpoints(
                self.spec["ckpt"], EF_KEEP,
                keep=[h["neval"] for h in self.opt._elastic_history])
        self._mark = (time.perf_counter(), ef_snapshot())
        if "end" in self.spec:
            return n > self.spec["end"]
        grown = [h["neval"] for h in self.opt._elastic_history
                 if h["kind"] in ("grow", "join")]
        return n > (grown[-1] + EF_AFTER_GROW if grown else EF_MAX_ITERS)

    def _barrier(self, done):
        d = self.spec["barrier"]
        mine = os.path.join(d, f"pos.{Engine.rank()}")
        with open(mine + ".tmp", "w") as f:
            f.write(str(done))
        os.replace(mine + ".tmp", mine)
        while True:
            behind = []
            for r in Engine.survivors():
                try:
                    with open(os.path.join(d, f"pos.{r}")) as f:
                        pos = int(f.read() or -1)
                except (OSError, ValueError):
                    pos = -1
                if pos < done:
                    behind.append(r)
            if not behind:
                return
            time.sleep(0.01)

    def add_scalar(self, tag, value, step):
        if tag != "Loss" or self._mark is None:
            return
        if EF_DEVICE != "cpu":
            torch.cuda.synchronize()
        t0, before = self._mark
        after = ef_snapshot()
        self._mark = None
        self.records.append({
            "neval": int(step), "loss": float(value),
            "ms": (time.perf_counter() - t0) * 1e3,
            "fwd": after[0] - before[0], "bwd": after[1] - before[1],
            "lse": after[2] - before[2],
            "fwd_routes": {k: after[3][k] - before[3][k] for k in after[3]},
            "bwd_routes": {k: after[4][k] - before[4][k] for k in after[4]},
            "world": Engine.world(), "batch": ef_batch(self.opt)})

    def get_summary_trigger(self, name):
        return None


def ef_batch(opt):
    from bigdl_torch.optim.optimizer import _find_batchers
    return _find_batchers(opt.dataset)[0].batch_size


def ef_run(spec, samples):
    """One Optimizer run of the bench LM at ``spec["batch"]`` a rank
    (``Adam(EF_LR)``, the data order pinned, B6 and B7 on ``"tc"``)."""
    model = TransformerLM(**LM).build(
        EF_DEVICE, torch.Generator().manual_seed(SEED))
    ds = DataSet.array(samples, distributed=True, seed=SEED).transform(
        SampleToMiniBatch(spec["batch"], drop_last=True))
    # the same order for drilled and clean runs: the shuffle is not in a
    # snapshot
    ds.shuffle = lambda: None
    opt = Optimizer(model, ds, nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(), size_average=True), device=EF_DEVICE)
    opt.set_optim_method(Adam(EF_LR))
    log = EfLog(spec, opt)
    opt.set_end_when(Trigger(log.end, "efSteps"))
    opt.set_train_summary(log)
    ckpt = spec["ckpt"]
    if spec.get("resume"):
        n = spec["resume"]
        opt.resume_from(os.path.join(ckpt, f"model.{n}"),
                        os.path.join(ckpt, f"optimMethod.{n}"))
    else:
        opt.set_checkpoint(ckpt, every_done(1),
                           publish=True if spec.get("publish") else None)
    zero_flash()
    t0 = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t0
    plan = opt._elastic_plan
    return {"records": log.records, "history": opt._elastic_history,
            "neval_resumed": plan.neval if plan is not None else None,
            "world_after": Engine.world(), "batch_after": ef_batch(opt),
            "launches": flash_counts(),
            "lse_launches": attn_ops.flash_attention.lse_launches,
            "fwd_routes": dict(attn_ops.flash_attention.route_launches),
            "bwd_routes": dict(attn_ops.flash_attention_bwd.route_launches),
            "wall_s": wall,
            "finite": all(bool(torch.isfinite(p).all())
                          for p in model.parameters())}


def ef_child(spec_json):
    """One process of the elastic drill (``--elastic-child SPEC``), on the
    card: the rank, the topology, elasticity, chaos and the trace come
    from the environment the parent set; ``spec["repeat"]`` runs in a
    row."""
    spec = json.loads(spec_json)
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    samples = lm_samples(EF_SAMPLES, LM["max_len"], LM["vocab_size"],
                         SEED + 21)
    runs = [ef_run(spec, samples) for _ in range(spec.get("repeat", 1))]
    emit({"role": spec["role"], "rank": Engine.rank(), "runs": runs})
    return 0


def ef_spawn(spec, env, log_dir):
    """``chip_smoke.py --elastic-child`` with ``env``; its output in
    ``log_dir``."""
    here = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("BIGDL_TORCH_ELASTIC", "BIGDL_TORCH_CHAOS",
                                 "BIGDL_TORCH_TRACE",
                                 "BIGDL_TORCH_SUPERVISE"))}
    base.update({"PYTHONPATH": here, "BIGDL_TORCH_PREFETCH_DEPTH": "0",
                 **env})
    out = open(os.path.join(log_dir, f"{spec['role']}.out"), "w+")
    err = open(os.path.join(log_dir, f"{spec['role']}.err"), "w+")
    proc = subprocess.Popen(
        [sys.executable, EF_SCRIPT or os.path.abspath(__file__),
         "--elastic-child", json.dumps(spec)], env=base, stdout=out,
        stderr=err, cwd=here)
    proc.files = (out, err)
    return proc


def ef_wait(proc, want_rc, timeout=EF_TIMEOUT):
    """The child's last JSON line, once it exits with ``want_rc``."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out, err = proc.files
    out.seek(0)
    err.seek(0)
    text, etext = out.read(), err.read()
    out.close()
    err.close()
    check(rc == want_rc, f"elastic child {proc.args[-1][:80]} exited {rc},"
          f" not {want_rc}:\n{text[-1500:]}\n{etext[-4000:]}")
    lines = [line for line in text.splitlines() if line.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def ef_trace(trace_dir, rank):
    """Rank ``rank``'s ``elastic.*`` events from its trace file."""
    with open(os.path.join(trace_dir, f"trace.{rank}.json")) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if str(e.get("name", "")).startswith(
        "elastic.")]


def ef_first(events, name, after=0.0):
    for e in events:
        if e["name"] == name and e["ts"] >= after:
            return e
    raise SmokeFailure(f"no {name} event after {after} in {events}")


def ef_step_checks(records, what):
    """Every step of a run: B6 8 (each with its log-sum-exp) and B7 16
    launches, all ``"tc"``."""
    bad = [r for r in records
           if (r["fwd"], r["bwd"], r["lse"]) != (EF_STEP["fwd"],
                                                 EF_STEP["bwd"],
                                                 EF_STEP["lse"])
           or r["fwd_routes"]["tc"] != r["fwd"]
           or r["bwd_routes"]["tc"] != r["bwd"]]
    check(records and not bad, f"{what}: steps off 8 B6 / 16 B7 on tc: "
          f"{bad[:3]}")


def ef_losses(records, lo, hi, world):
    """{neval: loss} of a run's last record of each neval in (lo, hi] at
    ``world``."""
    return {r["neval"]: r["loss"] for r in records
            if lo < r["neval"] <= hi and r["world"] == world}


def ef_hold(drilled, clean_runs, lo, hi, world, what):
    """The drilled losses over (lo, hi] against the two clean runs' under
    ``resume_rule``."""
    first, second = (ef_losses(c["records"], lo, hi, world)
                     for c in clean_runs)
    got = ef_losses(drilled, lo, hi, world)
    check(sorted(got) == sorted(first) == sorted(second)
          == list(range(lo + 1, hi + 1)),
          f"{what}: iterations {sorted(got)} {sorted(first)} "
          f"{sorted(second)}")
    keys = sorted(got)
    ok, rule, spread = resume_rule([got[k] for k in keys],
                                   [first[k] for k in keys],
                                   [second[k] for k in keys])
    check(ok, f"{what}: {got} against {first} {second} ({rule})")
    return {"iterations": keys, "losses": [got[k] for k in keys],
            "clean_losses": [first[k] for k in keys], "rule": rule,
            "spread": spread}


def ef_median(records, world, skip=1):
    ms = [r["ms"] for r in records[skip:] if r["world"] == world]
    return (float(np.median(ms)) if ms else None), ms


def ef_elastic(root):
    """(a) shrink and (b) grow of the bench LM on the card (module
    docstring, 21)."""
    ckpt, trace, barrier, logs = (os.path.join(root, d) for d in
                                  ("ckpt", "trace", "barrier", "logs"))
    for d in (ckpt, barrier, logs):
        os.makedirs(d)
    common = {"BIGDL_TORCH_ELASTIC_WORLD": "2",
              "BIGDL_TORCH_ELASTIC_PEER_LOST": str(EF_PEER_LOST),
              "BIGDL_TORCH_SUPERVISE_PEER_STALE": str(EF_PEER_LOST / 2),
              "BIGDL_TORCH_ELASTIC_JOIN_TIMEOUT": str(EF_TIMEOUT / 2)}
    spec = {"ckpt": ckpt, "batch": EF_BATCH, "barrier": barrier}
    t0 = time.perf_counter()
    p0 = ef_spawn({**spec, "role": "rank0", "publish": True, "prune": True},
                  {**common, "BIGDL_TORCH_ELASTIC_RANK": "0",
                   "BIGDL_TORCH_TRACE": trace}, logs)
    p1 = ef_spawn({**spec, "role": "rank1"},
                  {**common, "BIGDL_TORCH_ELASTIC_RANK": "1",
                   "BIGDL_TORCH_CHAOS": f"host.lost@1=exit@{EF_LOST_AT}"},
                  logs)
    try:
        ef_wait(p1, 117)
        lost_s = time.perf_counter() - t0
        pj = ef_spawn({**spec, "role": "joiner"},
                      {**common, "BIGDL_TORCH_ELASTIC_RANK": "1",
                       "BIGDL_TORCH_ELASTIC_JOIN": "1",
                       "BIGDL_TORCH_ELASTIC_JOIN_POLL": "0.1",
                       "BIGDL_TORCH_TRACE": trace,
                       "BIGDL_TORCH_CHAOS":
                           f"host.return@1=join@{EF_RETURN_AT}"}, logs)
        rj = ef_wait(pj, 0)["runs"][0]
        r0 = ef_wait(p0, 0)["runs"][0]
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
                p.wait()
    drill_s = time.perf_counter() - t0
    kinds = [h["kind"] for h in r0["history"]]
    check(kinds == ["shrink", "grow"] and [h["kind"] for h in rj["history"]]
          == ["join"], f"re-forms: rank 0 {r0['history']}, joiner "
          f"{rj['history']}")
    shrink, grow = r0["history"]
    check([shrink["world"], grow["world"], rj["history"][0]["world"]]
          == [1, 2, 2] and [shrink["batch"], grow["batch"],
                            rj["history"][0]["batch"]]
          == [2 * EF_BATCH, EF_BATCH, EF_BATCH]
          and rj["history"][0]["neval"] == grow["neval"],
          f"world 2 -> 1 -> 2, batch 16 -> 32 -> 16: {r0['history']} "
          f"{rj['history']}")
    check(r0["finite"] and rj["finite"], "non-finite weights after the "
          "drill")
    S, G = shrink["neval"], grow["neval"]
    end = G + EF_AFTER_GROW
    check(r0["records"][-1]["neval"] == rj["records"][-1]["neval"] == end,
          f"the drill's last iterations: {r0['records'][-1]} "
          f"{rj['records'][-1]}")
    for what, run in (("rank 0", r0), ("joiner", rj)):
        ef_step_checks(run["records"], what)
    # the clean runs: world 1 from the shrink's entry to the grow's, and
    # the two ranks of world 2 from the grow's to the end, each twice
    t1 = time.perf_counter()
    clean = [ef_spawn({"ckpt": ckpt, "batch": 2 * EF_BATCH, "role": "clean1",
                       "resume": S, "end": G, "repeat": 2}, {}, logs)]
    clean += [ef_spawn({"ckpt": ckpt, "batch": EF_BATCH,
                        "role": f"clean2_{r}", "resume": G, "end": end,
                        "repeat": 2},
                       {"BIGDL_TORCH_ELASTIC_WORLD": "2",
                        "BIGDL_TORCH_ELASTIC_RANK": str(r)}, logs)
              for r in (0, 1)]
    try:
        c1, c20, c21 = (ef_wait(p, 0)["runs"] for p in clean)
    finally:
        for p in clean:
            if p.poll() is None:
                p.kill()
                p.wait()
    clean_s = time.perf_counter() - t1
    for what, runs in (("clean world 1", c1), ("clean world 2 rank 0", c20),
                       ("clean world 2 rank 1", c21)):
        for run in runs:
            ef_step_checks(run["records"], what)
    held = {"shrink": ef_hold(r0["records"], c1, S, G, 1,
                              "world 1 after the shrink"),
            "grow_rank0": ef_hold(r0["records"], c20, G, end, 2,
                                  "rank 0 after the grow"),
            "grow_rank1": ef_hold(rj["records"], c21, G, end, 2,
                                  "the joiner after the grow")}
    # release ids gap-free across both resizes; a stub-served controller
    # promotes the releases published from the grow on (the drill's
    # retention pruned the snapshots of earlier ones)
    ids = sorted(int(m.group(1)) for n in os.listdir(ckpt)
                 for m in [re.fullmatch(tct.RELEASE_PATTERN, n)] if m)
    check(ids and ids == list(range(ids[0], ids[0] + len(ids))),
          f"release ids not gap-free: {ids}")

    class Stub:
        versions = 0

        def swap(self, source, canary_fraction=None):
            Stub.versions += 1
            return Stub.versions

        def stats(self):
            return {}
    ctrl = tct.DeployController(Stub(), ckpt, canary_fraction=0.0, since=0)
    handed = []
    for rid in ids:
        entry = tct.read_release(os.path.join(ckpt, f"release.{rid}"))
        if entry["neval"] >= G:
            handed.append(rid)
            ctrl._handle(rid, os.path.join(ckpt, f"release.{rid}"))
    after = [t for t in ctrl.timeline if t.get("action") == "promoted"
             and (t.get("neval") or -1) > G]
    check(not ctrl.counts["rejected"] and after,
          f"deploy across the resizes: {ctrl.counts} {ctrl.timeline[-3:]}")
    # the timeline in rank 0's and the joiner's traces
    ev0, evj = ef_trace(trace, 0), ef_trace(trace, 1)
    detect = ef_first(ev0, "elastic.detect")
    resume = ef_first(ev0, "elastic.resume", detect["ts"])
    negotiate = ef_first(ev0, "elastic.negotiate", detect["ts"])
    reform = ef_first(ev0, "elastic.reform", detect["ts"])
    grow_span = ef_first(ev0, "elastic.join", resume["ts"])
    intent = ef_first(evj, "elastic.join_intent")
    joined = ef_first(evj, "elastic.resume", intent["ts"])
    need = {"elastic.detect", "elastic.negotiate", "elastic.agree",
            "elastic.reform", "elastic.resume", "elastic.join"}
    names0 = sorted({e["name"] for e in ev0})
    check(need <= set(names0) and {"elastic.join", "elastic.join_intent",
                                   "elastic.agree", "elastic.reform",
                                   "elastic.resume"}
          <= {e["name"] for e in evj}, f"elastic events: {names0}")
    recs = r0["records"]
    before_ms = [r["ms"] for r in recs if r["neval"] <= S and r["neval"] > 1]
    mid_ms, mid = ef_median([r for r in recs if S < r["neval"] <= G], 1)
    after_ms, aft = ef_median([r for r in recs if r["neval"] > G], 2)
    launches = [r0["launches"], rj["launches"]]
    routes = {key: {k: r0[key][k] + rj[key][k] for k in r0[key]}
              for key in ("fwd_routes", "bwd_routes")}
    return {
        "neval_resumed": S, "world_after": shrink["world"],
        "batch_after": shrink["batch"], "grow_neval": G, "end": end,
        "history_rank0": r0["history"], "history_joiner": rj["history"],
        "detect_to_resume_ms": (resume["ts"] - detect["ts"]) / 1e3,
        "negotiate_ms": negotiate["dur"] / 1e3,
        "reform_ms": reform["dur"] / 1e3,
        "join_to_resume_ms": (joined["ts"] - intent["ts"]) / 1e3,
        "grow_span_ms_rank0": grow_span["dur"] / 1e3,
        "step_ms_world2_before": before_ms,
        "step_ms_world1_median": mid_ms, "step_ms_world1": mid,
        "step_ms_world2_after_median": after_ms,
        "step_ms_world2_after": aft,
        "held": held, "releases": len(ids), "releases_handed": handed,
        "promoted_after_grow": len(after), "rejected":
            ctrl.counts["rejected"],
        "elastic_events_rank0": names0,
        "elastic_events_joiner": sorted({e["name"] for e in evj}),
        "rank1_exit_s": lost_s, "drill_s": drill_s, "clean_s": clean_s,
        "b6_launches": sum(x[0] for x in launches),
        "b7_launches": sum(x[1] for x in launches),
        "lse_launches": r0["lse_launches"] + rj["lse_launches"], **routes}


def ef_kernel_cases():
    """B6 with its log-sum-exp and B7 at the shrunk world's call, [32, 8,
    512, 64] bf16 causal, against their plain versions, timed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    B, H, T = 2 * EF_BATCH, LM["num_heads"], LM["max_len"]
    D = LM["d_model"] // H
    b6 = flash_case(B, H, T, T, D, torch.bfloat16, True,
                    torch.Generator().manual_seed(SEED + 21), with_lse=True)
    b7 = b7_case(B, H, T, T, D, torch.bfloat16, True, gen)
    check(b6["ok"] and b7["ok"], f"B6 / B7 at [{B}, {H}, {T}, {D}]: {b6} "
          f"{b7}")
    return b6, b7


class EfTraffic:
    """Closed-loop requests through the front during the deploy; every
    one must be answered."""

    def __init__(self, front, queries):
        self.front, self.queries = front, queries
        self.submitted = self.served = 0
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=120)

    def _run(self):
        i = 0
        while not self._stop.is_set() and len(self.errors) < 8:
            self.submitted += 1
            try:
                self.front.submit(self.queries[i % len(self.queries)]) \
                    .result(60)
                self.served += 1
            except Exception as e:  # noqa: BLE001 - recorded, fails
                self.errors.append(f"{type(e).__name__}: {e}")
            i += 1
            time.sleep(0.005)


def ef_post(port, x, timeout=60):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps({"inputs": np.asarray(x).tolist()}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return np.asarray(json.loads(r.read())["outputs"], np.float32)


def ef_pct(ms):
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def ef_fleet(root):
    """(c) the serving fleet of LeNet-5 workers on the card (module
    docstring, 21)."""
    from bigdl_torch.serve import (FleetFront, FleetSupervisor,
                                   ReleasePublisher, fleet)
    fdir, lineage, logs = (os.path.join(root, d) for d in
                           ("fleet", "lineage", "fleet_logs"))
    for d in (fdir, lineage, logs):
        os.makedirs(d)
    here = os.path.dirname(os.path.abspath(__file__))
    spawned = {}

    def spawn(index, generation):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BIGDL_TORCH_ELASTIC",
                                    "BIGDL_TORCH_CHAOS", "BIGDL_TORCH_TRACE",
                                    "BIGDL_TORCH_FLEET",
                                    "BIGDL_TORCH_DEPLOY"))}
        env.update({"PYTHONPATH": here, **EF_FLEET_ENV})
        if index == 1 and generation == 1:
            # the zombie: this life's beat loop wedges while its HTTP
            # threads answer; the respawn comes back clean
            env["BIGDL_TORCH_CHAOS"] = f"fleet.member@1=wedge@{EF_WEDGE_BEAT}"
        log = open(os.path.join(logs, f"member.{index}.{generation}.log"),
                   "w")
        spawned[(index, generation)] = time.time()
        return subprocess.Popen(
            [sys.executable, "-m", "bigdl_torch.tools.serve_worker",
             "--fleet-dir", fdir, "--index", str(index), "--generation",
             str(generation), "--model", "lenet", "--heartbeat-s",
             str(EF_BEAT_S), *EF_WORKER_ARGS], env=env, stdout=log,
            stderr=log, cwd=here)

    def wait(pred, timeout, what):
        deadline = time.monotonic() + timeout
        while not pred():
            check(time.monotonic() < deadline, f"fleet: timed out waiting "
                  f"for {what}: {sup.stats()}")
            time.sleep(0.05)

    # the workers' float32 LeNet-5: the oracle computes in float32 too
    set_policy(DTypePolicy())
    zero_all_kernels()
    t0 = time.perf_counter()
    sup = FleetSupervisor(fdir, spawn, members=EF_FLEET,
                          lost_after_s=EF_LOST_AFTER_S, poll_s=0.2,
                          backoff_s=0.2, grace_s=300.0, restart_budget=3)
    front = FleetFront(fdir, refresh_s=0.1, lost_after_s=EF_LOST_AFTER_S,
                       retries=2, timeout_s=30.0, decision_timeout=120.0,
                       max_unavailable=1)
    controller = traffic = None
    try:
        sup.start()
        # a registry entry with no heartbeat behind it: never routed
        fleet.publish_member(fdir, index=7, generation=1, pid=999999,
                             port=1)
        wait(lambda: sup.live_count() >= EF_FLEET, 300, "3 live members")
        up_s = time.perf_counter() - t0
        members1 = front.members()
        check(sorted(members1) == list(range(EF_FLEET)),
              f"initial registry {sorted(members1)}")
        oracle1, _ = serve_http.build_model("lenet", EF_DEVICE)
        queries = np.random.default_rng(SEED + 22).random(
            (32, 28, 28, 1)).astype(np.float32)
        want1 = Predictor(oracle1, device=EF_DEVICE).predict(queries)
        events = [tracefile.TraceEvent(EF_REQUEST_DT,
                                       queries[i % len(queries)])
                  for i in range(EF_REQUESTS)]
        box = {}
        rt = threading.Thread(target=lambda: box.setdefault(
            "outcomes", tracefile.replay(
                events, lambda e: front.submit(e.payload), speed=1.0)),
            daemon=True)
        t_replay = time.perf_counter()
        rt.start()
        time.sleep(EF_KILL_AT_S)
        os.kill(members1[0]["pid"], signal.SIGKILL)
        rt.join(timeout=300)
        check(not rt.is_alive(), "fleet: the replay never finished")
        outcomes = box["outcomes"]
        tracefile.resolve_outcomes(outcomes, timeout=120.0)
        replay_s = time.perf_counter() - t_replay
        shed = [o for o in outcomes if o.handle is None]
        errors = [f"{type(o.error).__name__}: {o.error}" for o in outcomes
                  if o.error is not None]
        answered = [o for o in outcomes
                    if o.handle is not None and o.error is None]
        check(not errors and len(answered) == len(outcomes),
              f"fleet: accepted requests lost: {errors[:5]}")
        replay_err = max(
            float(np.abs(o.handle.result(1)
                         - want1[i % len(queries)]).max())
            for i, o in enumerate(outcomes))
        check(replay_err <= SERVE_ATOL, f"fleet: replayed answers vs "
              f"Predictor {replay_err}")

        def replaced():
            m = front.members()
            return (all(i in m and m[i]["generation"] >= 2 for i in (0, 1))
                    and sup.live_count() >= EF_FLEET)
        wait(replaced, 300, "generation-2 respawns")
        members2 = front.members()
        respawn = {}
        for i in (0, 1):
            with open(os.path.join(fdir, f"condemn.{i}")) as f:
                condemned = json.load(f)
            respawn[str(i)] = {
                "condemned_generation": condemned["generation"],
                "generation": members2[i]["generation"],
                "respawn_to_ready_s": members2[i]["wall_time"]
                - condemned["time"],
                "spawn_to_ready_s": members2[i]["wall_time"]
                - spawned[(i, members2[i]["generation"])]}
        check(all(r["condemned_generation"] >= 1 for r in respawn.values()),
              f"fleet: lost generations not condemned: {respawn}")
        check(7 not in front._routed and 7 not in front.members(),
              f"fleet: the stale entry was routed: {front._routed}")
        # (c) the rolling deploy
        model2 = LeNet5(10).build(EF_DEVICE,
                                  torch.Generator().manual_seed(SEED + 7))
        params, state = to_reference_tree(model2)
        snap = os.path.join(lineage, "model.1")
        file_io.save({"params": params, "state": state}, snap)
        ReleasePublisher(lineage).publish(snap, neval=1)
        traffic = EfTraffic(front, queries).start()
        t_deploy = time.perf_counter()
        controller = tct.DeployController(
            front, lineage, canary_fraction=EF_CANARY, poll_s=0.1,
            decision_timeout=120.0, max_unavailable=1).start()
        wait(lambda: controller.stats()["promoted"] >= 1, 300,
             "the release to promote")
        deploy_s = time.perf_counter() - t_deploy
        traffic.stop()
        fst = front.stats()
        deploy = {"canary": fst.get("canary"),
                  "rolled": fst["fleet"]["deploy"]["rolled"],
                  "max_concurrent": fst["fleet"]["deploy"]["max_concurrent"],
                  "traffic_submitted": traffic.submitted,
                  "traffic_served": traffic.served,
                  "traffic_errors": traffic.errors[:5]}
        check(not traffic.errors and traffic.served == traffic.submitted
              and fst["fleet"]["deploy"]["max_concurrent"] <= 1
              and (fst.get("canary") or {}).get("state") == "promoted"
              and deploy["rolled"] == EF_FLEET - 1,
              f"fleet: the rolling deploy {deploy}")
        want2 = Predictor(model2, device=EF_DEVICE).predict(queries)
        worst = 0.0
        for i, rec in front.members().items():
            worst = max(worst, float(np.abs(
                ef_post(rec["port"], queries) - want2).max()))
        got = np.stack([front.predict(q, timeout=60) for q in queries])
        worst = max(worst, float(np.abs(got - want2).max()))
        check(worst <= SERVE_ATOL, f"fleet: answers after the roll vs "
              f"Predictor {worst}")
        # latency: sequential requests through the front and to one member
        port0 = front.members()[0]["port"]
        lat = {"front": [], "member": []}
        for k in range(EF_LATENCY_N):
            q = queries[k % len(queries)]
            t = time.perf_counter()
            front.predict(q, timeout=60)
            lat["front"].append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            ef_post(port0, q)
            lat["member"].append((time.perf_counter() - t) * 1e3)
        sst = sup.stats()
        check(not sst["degraded"], f"fleet: a slot degraded: {sst}")
        retried = fst["fleet"]["retried"]
    finally:
        if traffic is not None:
            traffic.stop()
        if controller is not None:
            controller.stop()
        front.close()
        sup.stop()
    launched = all_kernel_counts()
    check(not any(launched.values()), f"fleet: kernels launched in the "
          f"front's process: {launched}")
    return {"members_up_s": up_s, "requests": len(outcomes),
            "answered": len(answered), "shed": len(shed),
            "retried": retried, "replay_s": replay_s,
            "replay_max_abs_err": replay_err, "respawn": respawn,
            "stale_entry_routed": False, "deploy_s": deploy_s,
            "deploy": deploy, "answers_max_abs_err_after_roll": worst,
            "tol": SERVE_ATOL, "latency": {k: ef_pct(v)
                                           for k, v in lat.items()},
            "supervisor": {"restarts": sst["restarts"],
                           "degraded": sst["degraded"]},
            "front_process_kernel_launches": launched}


def phase_elastic_fleet():
    """Elastic training of the bench LM and the serving fleet (module
    docstring, 21); returns the kernels line's rows."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="elastic_fleet_")
    try:
        el = ef_elastic(root)
        b6, b7 = ef_kernel_cases()
        fl = ef_fleet(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "elastic_fleet", "gpu": gpu_line(), "elastic": el,
          "b6_case": b6, "b7_case": b7, "fleet": fl,
          "phase_s": time.perf_counter() - t_phase})
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "bigdl_torch/csrc/flash_attention.cu",
         "replaces": "bigdl_tpu/ops/attention.py:59",
         "launches": el["b6_launches"], "path": "elastic_fleet",
         "max_abs_err": b6["max_abs_err"],
         "lse_max_abs_err": b6["lse_max_abs_err"], "ms": b6["ms"],
         "plain_ms": b6["plain_ms"], "bound_ms": b6["bound_ms"],
         "bound_by": b6["bound_by"], "library_ms": b6["library_ms"],
         "ms_over_library": b6["ms_over_library"],
         "kernel_route": b6["route"], "route_launches": el["fwd_routes"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "bigdl_torch/csrc/flash_attention_bwd.cu",
         "replaces": "bigdl_tpu/ops/attention.py:182",
         "launches": el["b7_launches"], "path": "elastic_fleet",
         "max_abs_err": b7["max_abs_err"], "ms": b7["ms"],
         "plain_ms": b7["plain_ms"], "bound_ms": b7["bound_ms"],
         "bound_by": b7["bound_by"], "library_ms": b7["library_ms"],
         "ms_over_library": b7["ms_over_library"],
         "kernel_route": b7["route"], "route_launches": el["bwd_routes"]}]


# ---------------------------------------------------------------------------
# 22. observe: timing, FLOPs and mfu, the module profiler, traces, memory
# ---------------------------------------------------------------------------

OB_STEPS = 6               # traced LM steps
OB_TIMING_RATIO = 1.25     # measure_step_seconds against the events' time
OB_TOP_KERNELS = 10
B6_KERNEL = "flash_tc_kernel"
B7_KERNELS = ("bwd_dq_tc_kernel", "bwd_dkv_tc_kernel")


def train_rows(trace_dir):
    """The ``train`` counter track's events of a trace dir, in order."""
    merged = telemetry.merge_traces(trace_dir)
    return [e["args"] for e in merged["traceEvents"]
            if e.get("ph") == "C" and e.get("name") == "train"]


def traced_train(model, samples, steps, batch, trace_dir):
    """``train_lm`` with ``BIGDL_TORCH_TRACE`` at ``trace_dir``; returns
    (losses, the ``train`` track's events)."""
    with knobs({"BIGDL_TORCH_TRACE": trace_dir}):
        losses = train_lm(model, samples, steps, batch)
    return losses, train_rows(trace_dir)


def check_mfu(rows, steps, what):
    mfu = [r.get("mfu") for r in rows]
    check(len(rows) == steps and all(m is not None and 0 < m <= 1
                                     for m in mfu),
          f"{what}: train track mfu {mfu} over {len(rows)} rows")
    return mfu


def lm_closed_form_flops(model, batch, seq):
    """FLOPs of an LM train step: 3 x 2 x tokens x in x out over every
    ``Linear`` and every attention's four E x E projections (forward, and
    the input and weight gradients), plus 12·B·H·T²·D per attention layer
    (B6's 4 and B7's 8)."""
    tokens = batch * seq
    linear = sum(m.input_size * m.output_size for m in model.modules()
                 if isinstance(m, nn.Linear))
    mhas = [m for m in model.modules()
            if isinstance(m, nn.MultiHeadAttention)]
    linear += sum(4 * m.embed_dim * m.embed_dim for m in mhas)
    attn = sum(12 * batch * m.num_heads * seq * seq * m.head_dim
               for m in mhas)
    return 6 * tokens * linear + attn


def step_runner(opt, samples, batch):
    """One ``Optimizer._step`` on a fixed batch, the way
    ``tools/perf.py`` times a step; returns a callable giving the loss."""
    params = opt._params()
    state = {"opt": opt.optim_method.init_state(params)}
    rng = opt._dropout_generator()
    x = torch.from_numpy(np.stack([s.feature for s in samples[:batch]])
                         ).cuda()
    y = torch.from_numpy(np.stack([s.label for s in samples[:batch]])
                         ).cuda()
    opt.model.train()

    def one():
        loss, state["opt"] = opt._step(params, state["opt"], x, y, LM_LR,
                                       rng)
        return loss
    return one


def counted_step_ms(run):
    """ms of one step run under a FLOP count (``utils/flops.py``), the
    card synchronized before and after: what arming the mfu counter adds
    to a traced run's first step, beside ``measure_step_seconds``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flops.fn_flops(run)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def events_of_measured(run):
    """``timing.measure_step_seconds(run)`` and the same steps read from
    CUDA events of their own: a pair around every call, grouped by the
    helper's progress beats (one after each warm call, each chain and
    each single call) and reduced as the helper reduces its own readings
    (the best chains of ``n1`` and ``n2`` calls differenced, or where it
    fell back, the median of its single calls).  Returns (seconds a step,
    the helper's details, the events' ms a step)."""
    calls, beats = [], []

    def timed():
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = run()
        b.record()
        calls.append((a, b))
        return out
    step_s, detail = timing.measure_step_seconds(
        timed, progress=lambda: beats.append(len(calls)))
    torch.cuda.synchronize()
    groups = [calls[i:j] for i, j in zip([0] + beats, beats)]

    def span(g):
        return g[0][0].elapsed_time(g[-1][1])
    n1, n2 = detail["n1"], detail["n2"]
    last = max(i for i, g in enumerate(groups) if len(g) == n2)
    if detail.get("fallback") == "sync":
        singles = sorted(span(g) for g in groups[last + 2:])
        return step_s, detail, singles[len(singles) // 2]
    best = {n: min(span(g) for g in groups[:last + 1] if len(g) == n)
            for n in (n1, n2)}
    return step_s, detail, (best[n2] - best[n1]) / (n2 - n1)


def profiled_modules(model, samples, batch):
    """``ModuleProfiler`` over one forward and backward of the model:
    (leaves with parameters and a zero forward time, ``Linear`` modules
    with a zero backward time, the summary's top rows)."""
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
    x = torch.from_numpy(np.stack([s.feature for s in samples[:batch]])
                         ).cuda()
    y = torch.from_numpy(np.stack([s.label for s in samples[:batch]])
                         ).cuda()
    model.train()
    model.zero_grad(set_to_none=True)
    with profiling.ModuleProfiler(model) as prof:
        crit(model(x), y).backward()
    model.zero_grad(set_to_none=True)
    times = prof.get_times()
    no_fwd = [m.name for m, f, _ in times
              if list(m.parameters(recurse=False)) and not f > 0]
    no_bwd = [m.name for m, _, b in times
              if isinstance(m, nn.Linear) and not b > 0]
    top = sorted(times, key=lambda r: -(r[1] + r[2]))[:8]
    return no_fwd, no_bwd, [{"module": m.name, "fwd_ms": f * 1e3,
                             "bwd_ms": b * 1e3} for m, f, b in top]


def traced_kernels(run, logdir):
    """``trace_steps`` over 3 steps: the device kernels of the trace by
    total time, [(ms, count, name)]."""
    profiling.trace_steps(run, 3, logdir)
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    by = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by[e["name"]][0] += e["dur"] / 1e3
            by[e["name"]][1] += 1
    return sorted(((ms, n, name) for name, (ms, n) in by.items()),
                  reverse=True)


def trace_report_json(trace_dir):
    """``python -m bigdl_torch.tools.trace_report DIR --json`` in this
    process: (exit code, the parsed breakdown)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = trace_report.main([trace_dir, "--json"])
    return rc, json.loads(out.getvalue()) if rc == 0 else None


def flash_rows(b6, b7, fwd, bwd, path, fwd_routes, bwd_routes):
    """The kernels line's B6 and B7 rows of a path."""
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "bigdl_torch/csrc/flash_attention.cu",
         "replaces": "bigdl_tpu/ops/attention.py:59", "launches": fwd,
         "path": path, "max_abs_err": b6["max_abs_err"],
         "lse_max_abs_err": b6["lse_max_abs_err"], "ms": b6["ms"],
         "plain_ms": b6["plain_ms"], "bound_ms": b6["bound_ms"],
         "bound_by": b6["bound_by"], "library_ms": b6["library_ms"],
         "ms_over_library": b6["ms_over_library"],
         "kernel_route": b6["route"], "route_launches": fwd_routes,
         "shape": b6["shape"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "bigdl_torch/csrc/flash_attention_bwd.cu",
         "replaces": "bigdl_tpu/ops/attention.py:182", "launches": bwd,
         "path": path, "max_abs_err": b7["max_abs_err"], "ms": b7["ms"],
         "plain_ms": b7["plain_ms"], "bound_ms": b7["bound_ms"],
         "bound_by": b7["bound_by"], "library_ms": b7["library_ms"],
         "ms_over_library": b7["ms_over_library"],
         "kernel_route": b7["route"], "route_launches": bwd_routes,
         "shape": b7["shape"]}]


def flash_pair_cases(B, H, T, D, seed):
    """B6 with the log-sum-exp and B7 at [B, H, T, D] bf16 causal against
    their plain versions."""
    b6 = flash_case(B, H, T, T, D, torch.bfloat16, True,
                    torch.Generator().manual_seed(seed), with_lse=True)
    b7 = b7_case(B, H, T, T, D, torch.bfloat16, True,
                 torch.Generator(device="cuda").manual_seed(seed))
    check(b6["ok"] and b7["ok"], f"B6 / B7 at {[B, H, T, D]}: {b6} {b7}")
    return b6, b7


def phase_observe():
    """The observability modules on the bench LM (module docstring, 22);
    returns the kernels line's rows."""
    t_phase = time.perf_counter()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    roof = timing.measure_roofline()
    peak, peak_src = flops.device_peak_flops()
    check(roof is not None and roof > 0, f"measure_roofline: {roof}")
    T, V = LM["max_len"], LM["vocab_size"]
    H, D = LM["num_heads"], LM["d_model"] // LM["num_heads"]
    samples = lm_samples(LM_BATCH * OB_STEPS, T, V, SEED + 21)
    model = TransformerLM(**LM).build(
        "cuda", torch.Generator().manual_seed(SEED))
    root = tempfile.mkdtemp(prefix="observe_")
    try:
        tdir = os.path.join(root, "trace")
        torch.cuda.reset_peak_memory_stats()
        zero_flash()
        t0 = time.perf_counter()
        losses, rows = traced_train(model, samples, OB_STEPS, LM_BATCH,
                                    tdir)
        traced_s = time.perf_counter() - t0
        fwd, bwd = flash_counts()
        lse = attn_ops.flash_attention.lse_launches
        fwd_routes = dict(attn_ops.flash_attention.route_launches)
        bwd_routes = dict(attn_ops.flash_attention_bwd.route_launches)
        check_lm_launches(OB_STEPS, "observe: traced LM")
        check(lse == fwd, f"observe: {lse} of {fwd} B6 launches wrote the "
              "log-sum-exp")
        check(all(map(math.isfinite, losses)), f"observe losses {losses}")
        mem = memstats.memory_record(model, device="cuda")
        closed = lm_closed_form_flops(model, LM_BATCH, T)
        counted = [r.get("model_flops_per_step") for r in rows]
        check(counted and all(c == closed for c in counted),
              f"observe: model_flops_per_step {counted} != the closed "
              f"form {closed}")
        mfu = check_mfu(rows, OB_STEPS, "observe")
        rc, report = trace_report_json(tdir)
        check(rc == 0 and "step" in report["phases"]
              and "train.mfu" in report["counters"],
              f"observe: trace_report exit {rc}, phases "
              f"{sorted((report or {}).get('phases', {}))}")

        one = step_runner(train.opt, samples, LM_BATCH)
        step_s, detail, ev_ms = events_of_measured(one)
        count_ms = counted_step_ms(one)
        ratio_t = step_s * 1e3 / ev_ms
        check(1 / OB_TIMING_RATIO <= ratio_t <= OB_TIMING_RATIO,
              f"observe: measure_step_seconds {step_s * 1e3:.3f} ms vs "
              f"the events' {ev_ms:.3f} ms a step")
        no_fwd, no_bwd, prof_top = profiled_modules(model, samples,
                                                    LM_BATCH)
        check(not no_fwd and not no_bwd,
              f"observe: ModuleProfiler gave no forward time to {no_fwd}, "
              f"no backward time to {no_bwd}")
        kernels = traced_kernels(one, os.path.join(root, "prof"))
        names = [k[2] for k in kernels]
        b6_in = any(B6_KERNEL in n for n in names)
        b7_in = all(any(k in n for n in names) for k in B7_KERNELS)
        check(b6_in and b7_in, f"observe: trace_steps' kernels lack B6 "
              f"or B7: {names[:40]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model, one
    train.opt = None
    torch.cuda.empty_cache()
    b6, b7 = flash_pair_cases(LM_BATCH, H, T, D, SEED + 22)
    emit({"phase": "observe", "gpu": gpu_line(),
          "roofline_tflops": roof / 1e12, "table_peak_tflops": peak / 1e12,
          "peak_source": peak_src, "roofline_share_of_peak": roof / peak,
          "steps": OB_STEPS, "losses": losses, "traced_s": traced_s,
          "model_flops_per_step": counted[0], "closed_form_flops": closed,
          "mfu": mfu, "step_ms_measured": step_s * 1e3,
          "step_timing_detail": detail, "step_ms_events": ev_ms,
          "timing_ratio": ratio_t, "counted_step_ms": count_ms,
          "module_profile_top": prof_top,
          "top_kernels": [{"ms": ms, "count": n, "name": name[:120]}
                          for ms, n, name in kernels[:OB_TOP_KERNELS]],
          "b6_in_top": any(B6_KERNEL in k[2]
                           for k in kernels[:OB_TOP_KERNELS]),
          "b7_in_top": any(B7_KERNELS[0] in k[2] or B7_KERNELS[1] in k[2]
                           for k in kernels[:OB_TOP_KERNELS]),
          "trace_phases": sorted(report["phases"]),
          "train_mfu_counter": report["counters"]["train.mfu"],
          "memory": mem, "flash_launches": fwd, "flash_bwd_launches": bwd,
          "b6_case": b6, "b7_case": b7,
          "phase_s": time.perf_counter() - t_phase})
    return flash_rows(b6, b7, fwd, bwd, "observe", fwd_routes, bwd_routes)


# ---------------------------------------------------------------------------
# 23. train_moe: the transformer_moe config
# ---------------------------------------------------------------------------

MOE = dict(vocab_size=16000, max_len=256, d_model=512, num_heads=8,
           num_layers=4, num_experts=8)
MOE_BATCH = 16
MOE_STEPS = 20
MOE_PERIOD = 16            # the samples count up modulo this
MOE_FIRST_ATOL = 1.0       # the first loss within this of ln(vocab)
MOE_MIN_DROP = 0.25        # the last loss below the first by this


def counting_samples(n, seq, period, seed):
    """Next-token pairs of sequences that count up modulo ``period`` from
    a random start (``default_rng(seed)``): each next token follows from
    the current one, so a few steps have something to learn."""
    start = np.random.default_rng(seed).integers(0, period, (n, 1))
    toks = ((start + np.arange(seq + 1)) % period).astype(np.int32)
    return [Sample(toks[i, :-1], toks[i, 1:]) for i in range(n)]


def moe_routing_card_vs_cpu(model, samples):
    """The first MoE layer's routing of a batch's float32 gate logits on
    the card and on the CPU: (bit-equal masks, tokens dropped)."""
    moe = next(m for m in model.modules() if isinstance(m, moe_mod.MoEFFN))
    x = torch.from_numpy(np.stack([s.feature for s in samples[:MOE_BATCH]])
                         ).cuda()
    with torch.no_grad():
        h = model.layers[1](model.layers[0](x))       # embeddings
        h = h.float().reshape(-1, h.shape[-1])
        logits = h @ moe.gate.float()
    cap = moe._capacity(h.shape[0])
    card = moe_mod.top_k_routing(logits, cap, moe.k)
    host = moe_mod.top_k_routing(logits.cpu(), cap, moe.k)
    same = (torch.equal(card[1].cpu(), host[1])
            and torch.equal(card[3].cpu(), host[3]))
    dropped = int(h.shape[0] * moe.k - host[1].sum().item())
    return same, dropped, cap


def phase_train_moe():
    """The transformer_moe config trained on the card (module docstring,
    23); returns the kernels line's rows."""
    t_phase = time.perf_counter()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    T, V, L = MOE["max_len"], MOE["vocab_size"], MOE["num_layers"]
    H, D = MOE["num_heads"], MOE["d_model"] // MOE["num_heads"]
    samples = counting_samples(MOE_BATCH * MOE_STEPS, T, MOE_PERIOD,
                               SEED + 23)
    model = TransformerLM(**MOE).build(
        "cuda", torch.Generator().manual_seed(SEED))
    moes = [m for m in model.modules() if isinstance(m, moe_mod.MoEFFN)]
    check(len(moes) == L and all(
        (m.num_experts, m.d_hidden, m.k, m.capacity_factor)
        == (MOE["num_experts"], 4 * MOE["d_model"], 1, 1.25) for m in moes),
        f"train_moe: MoE layers {[(m.num_experts, m.d_hidden) for m in moes]}")
    same, dropped, cap = moe_routing_card_vs_cpu(model, samples)
    check(same, "train_moe: the routing on the card differs from the CPU "
          "route's on the same logits")
    root = tempfile.mkdtemp(prefix="train_moe_")
    try:
        zero_flash()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses, rows = traced_train(model, samples, MOE_STEPS, MOE_BATCH,
                                    os.path.join(root, "trace"))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fwd, bwd = flash_counts()
    lse = attn_ops.flash_attention.lse_launches
    fwd_routes = dict(attn_ops.flash_attention.route_launches)
    bwd_routes = dict(attn_ops.flash_attention_bwd.route_launches)
    check_lm_launches(MOE_STEPS, "train_moe", layers=L)
    check(lse == fwd, f"train_moe: {lse} of {fwd} B6 launches wrote the "
          "log-sum-exp")
    check(len(losses) == MOE_STEPS and all(map(math.isfinite, losses))
          and abs(losses[0] - math.log(V)) <= MOE_FIRST_ATOL
          and losses[-1] < losses[0] - MOE_MIN_DROP,
          f"train_moe losses {losses}")
    mfu = check_mfu(rows, MOE_STEPS, "train_moe")
    aux = [float(m.aux_loss) for m in moes]
    check(all(math.isfinite(a) and a > 0 for a in aux),
          f"train_moe: aux losses {aux}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = [r["step_s"] * 1e3 for r in rows]
    del model, moes
    train.opt = None
    torch.cuda.empty_cache()
    b6, b7 = flash_pair_cases(MOE_BATCH, H, T, D, SEED + 24)
    emit({"phase": "train_moe", "gpu": gpu_line(), "config": MOE,
          "batch": MOE_BATCH, "steps": MOE_STEPS, "losses": losses,
          "aux_losses": aux, "routing_bit_equal": same,
          "routing_capacity": cap, "routing_dropped": dropped,
          "mfu": mfu, "model_flops_per_step": rows[0].get(
              "model_flops_per_step"), "host_step_ms": step_ms,
          "run_s": run_s, "tokens_per_s": MOE_BATCH * T * MOE_STEPS / run_s,
          "max_memory_allocated": peak, "flash_launches": fwd,
          "flash_bwd_launches": bwd, "b6_case": b6, "b7_case": b7,
          "phase_s": time.perf_counter() - t_phase})
    return flash_rows(b6, b7, fwd, bwd, "train_moe", fwd_routes, bwd_routes)


# -- 24. pipeline and sequence parallelism ----------------------------------

PIPE_LM = dict(vocab_size=16000, max_len=256, d_model=512, num_heads=8,
               num_layers=8)
PS_BATCH = 16
PS_STEPS = 5
PS_MICRO = 4
PS_LOSS_TOL = 2e-3         # the reference's LOSS_TOL
#: |Δ - Δref| / |Δref| of each unit's weight change over the run (the
#: embeddings, each block's attention and feed-forward, the head; 2-norms) against the unpartitioned
#: (or dense) LM's: every gradient is rounded to bf16 on its way to the
#: update (2^-8 apart at most where two runs round a value differently)
#: and the microbatches' bf16 products differ from the whole batch's in
#: their last bits; a lost or misrouted gradient moves a unit by ~1
PS_DELTA_TOL = 2e-2
PS_RUNS = (("gpipe", 1), ("1f1b", 1), ("1f1b", 2))
PS_TIMEOUT = 600
#: B6 (its log-sum-exp launches) and B7 launches a rank makes in one step
#: of the pipelined LM (8 layers, 4 microbatches, 2 ranks): under gpipe
#: every stage forward keeps its graph (one B6 with the log-sum-exp each)
#: and is pulled back once (one B7 call, 2 launches); under 1f1b the
#: forward runs without a graph and the backward's table runs each stage
#: forward again with its graph before its backward
PS_PIPE_STEP = {"gpipe": (16, 16, 32), "1f1b": (32, 16, 32)}
#: B6 and B7 launches a rank makes in one step of the seq-parallel LM (8
#: layers on 2 ranks, causal): rank 0 attends to its own block, rank 1 to
#: the block below its diagonal too; every ring block is one B6 with the
#: log-sum-exp and one B7 call
PS_SEQ_STEP = {0: (8, 16), 1: (16, 32)}
PS_FN_SHAPE = (16, 8, 512, 64)


def ps_tokens():
    """Fixed tokens for the dense and seq-parallel LMs' log-probs."""
    return torch.from_numpy(np.random.default_rng(SEED + 26).integers(
        0, LM["vocab_size"], (2, LM["max_len"]))).long().cuda()


def ps_step_ms(steps):
    """``train_lm``'s ``on_step`` hook and the host ms of each step."""
    marks = []

    def on_step(n):
        marks.append(time.perf_counter())
    return on_step, lambda: [1e3 * (b - a) for a, b in zip(marks, marks[1:])]


def ps_train(model, samples, seq, trace=None):
    """``train_lm`` over ``PS_STEPS`` steps from zeroed B6 / B7 counts:
    (losses, a record of the run)."""
    on_step, step_ms = ps_step_ms(PS_STEPS)
    zero_flash()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with knobs({"BIGDL_TORCH_TRACE": trace} if trace else {}):
        losses = train_lm(model, samples, PS_STEPS, PS_BATCH,
                          on_step=on_step)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fwd, bwd = flash_counts()
    return losses, {
        "losses": losses, "host_step_ms": step_ms(), "run_s": run_s,
        "tokens_per_s": PS_BATCH * seq * PS_STEPS / run_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "b6": fwd, "b6_lse": attn_ops.flash_attention.lse_launches,
        "b7": bwd, "routes": flash_routes()}


def ps_functions(rank, n, out_dir):
    """This rank's shards of ``ring_attention`` (causal and not) and
    ``ulysses_attention`` (causal) at ``PS_FN_SHAPE`` bf16, their q, k, v
    gradients against a fixed output gradient, saved for the parent."""
    B, H, T, D = PS_FN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    q, k, v, do = (torch.randn((B, H, T, D), device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    rows = slice(rank * T // n, (rank + 1) * T // n)
    out, launches = {}, {}
    for name, fn, causal in (("ring", ring_attention, False),
                             ("ring_causal", ring_attention, True),
                             ("ulysses_causal", ulysses_attention, True)):
        zero_flash()
        shards = [t[:, :, rows].clone().requires_grad_() for t in (q, k, v)]
        o = fn(*shards, causal=causal)
        o.backward(do[:, :, rows])
        torch.cuda.synchronize()
        launches[name] = flash_counts()
        out[name] = [o.detach().cpu()] + [t.grad.cpu() for t in shards]
    torch.save(out, os.path.join(out_dir, f"functions.rank{rank}.pt"))
    return launches


def pipe_seq_child(out_dir):
    """One rank of ``pipe_seq`` (b): the pipelined runs on a ``pipe``
    mesh, then the seq-parallel LM and functions on a ``seq`` mesh of the
    same two processes."""
    import torch.distributed as dist
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    Engine.init(device="cuda:0", backend="gloo", mesh_shape={"pipe": 2})
    rank, world = dist.get_rank(), dist.get_world_size()
    T, V = PIPE_LM["max_len"], PIPE_LM["vocab_size"]
    samples = lm_samples(PS_BATCH * PS_STEPS, T, V, SEED + 25)
    ref = torch.load(os.path.join(out_dir, "pipe_delta.pt"))
    runs = {}
    for sched, v in PS_RUNS:
        model = TransformerLM(**PIPE_LM).build(
            "cuda", torch.Generator().manual_seed(SEED))
        piped = partition_pipeline(model, 2 * v, num_microbatches=PS_MICRO,
                                   schedule=sched, virtual_stages=v)
        del model
        trace = os.path.join(out_dir, f"trace-{sched}-{v}-{rank}")
        init = ps_units(piped)
        _, rec = ps_train(piped, samples, T, trace)
        trained = ps_units(piped)
        pipe = piped.layers[2]
        rec.update(delta_errs=ps_delta_errs(init, trained, ref),
                   rank_max_abs_diff=ps_rank_diff(trained),
                   description=train.opt.run_description,
                   peak_stash=pipe.last_peak_stash,
                   bubble=[r.get("pipe_bubble_fraction")
                           for r in train_rows(trace)])
        runs[f"{sched}-{v}"] = rec
        del piped, pipe, init, trained
        train.opt = None
        torch.cuda.empty_cache()
    pipe_hops = dict(hops_mod.host_copies)
    dist.barrier()
    Engine.reset()
    os.environ["BIGDL_TORCH_COORDINATOR"] = f"file://{out_dir}/store_seq"
    Engine.init(device="cuda:0", backend="gloo", mesh_shape={"seq": 2})
    model = TransformerLM(**LM, seq_parallel=True).build(
        "cuda", torch.Generator().manual_seed(SEED))
    init = ps_units(model)
    model.eval()
    with torch.no_grad():
        logp = model(ps_tokens()).float().cpu()
    torch.save(logp, os.path.join(out_dir, f"seq_logp.rank{rank}.pt"))
    model.train()
    seq_samples = lm_samples(PS_BATCH * PS_STEPS, LM["max_len"],
                             LM["vocab_size"], SEED + 28)
    _, seq_rec = ps_train(model, seq_samples, LM["max_len"])
    trained = ps_units(model)
    seq_rec.update(delta_errs=ps_delta_errs(init, trained, torch.load(
        os.path.join(out_dir, "seq_delta.pt"))),
        rank_max_abs_diff=ps_rank_diff(trained))
    del model, init, trained
    train.opt = None
    torch.cuda.empty_cache()
    fn_launches = ps_functions(rank, world, out_dir)
    emit({"rank": rank, "world": world, "runs": runs, "seq": seq_rec,
          "function_launches": fn_launches, "host_copies": {
              "pipe": pipe_hops, "all": dict(hops_mod.host_copies)}})
    dist.barrier()
    Engine.reset()
    return 0


def ps_units(model):
    """The model's weights as float32 vectors on its device, one a unit,
    in the unpartitioned model's order: the children before the first
    transformer block (the embeddings), each block's two residual
    branches (attention, feed-forward), the children after the last (the
    head).  A partitioned model's stack is unstacked: stage s is row
    ``stack_index`` of s, and its blocks follow in order.  A model of
    another kind is one unit."""
    tree, _ = to_reference_tree(model, fetch=lambda t: t.detach().float())

    def flat(t, k=None):
        return torch.cat([(x if k is None else x[k]).reshape(-1)
                          for x in tree_leaves(t)])
    def block(m):
        # TransformerBlock: two residual branches, ConcatTable + CAddTable
        return isinstance(m, nn.Sequential) and isinstance(
            m.layers[0], nn.Sequential) and isinstance(
            m.layers[0].layers[0], nn.ConcatTable)
    body = [i for i, c in enumerate(getattr(model, "layers", ()))
            if block(c) or isinstance(c, GPipeSequential)]
    if type(model) is not nn.Sequential or not body:
        return [flat(tree)]
    out = [flat(tree[:body[0]])]
    for child, t in zip(model.layers[body[0]:body[-1] + 1],
                        tree[body[0]:body[-1] + 1]):
        if isinstance(child, GPipeSequential):
            S, v = child.num_stages, child.virtual_stages
            blocks = [t] if block(child.stage) else t
            out += [flat(branch, stack_index(s, S // v, v))
                    for s in range(S) for b in blocks for branch in b]
        else:
            out += [flat(branch) for branch in t]
    return out + [flat(tree[body[-1] + 1:])]


def ps_delta(init, trained):
    """Each unit's change over a run, on the host."""
    return [(t - i).cpu() for i, t in zip(init, trained)]


def ps_delta_errs(init, trained, ref):
    """|Δ - Δref| / |Δref| of each unit (2-norms), Δ = trained - init."""
    return [float((t - i - r.to(t.device)).norm() / r.to(t.device).norm())
            for i, t, r in zip(init, trained, ref)]


def ps_rank_diff(units):
    """max |rank 0's weights - rank 1's| (0.0: bit-equal) over the two
    ranks of the default group."""
    import torch.distributed as dist
    x = torch.cat(units)
    if dist.get_rank():
        x.neg_()
    dist.all_reduce(x)
    return float(x.abs().max())


def ps_weights_check(rec, what):
    """A two-rank run's trained weights: bit-equal on both ranks, and each
    unit's change within ``PS_DELTA_TOL`` of the one-process run's."""
    errs = rec["delta_errs"]
    check(max(errs) <= PS_DELTA_TOL, f"{what}: the weights' change is "
          f"not the one-process run's: |Δ - Δref| / |Δref| by unit {errs} "
          f"beyond {PS_DELTA_TOL}")
    check(rec["rank_max_abs_diff"] == 0.0, f"{what}: the ranks' trained "
          f"weights differ by up to {rec['rank_max_abs_diff']}")


def ps_close(got, want, tol, what):
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    check(ok, f"{what}: max abs err {float(err.max())} beyond "
          f"atol {atol} rtol {rtol}")
    return float(err.max())


def ps_functions_check(tmp):
    """The ranks' function shards assembled against one B6 / B7 call on
    the whole tensors."""
    B, H, T, D = PS_FN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    q, k, v, do = (torch.randn((B, H, T, D), device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    ranks = [torch.load(os.path.join(tmp, f"functions.rank{r}.pt"))
             for r in range(2)]
    errs = {}
    for name, causal in (("ring", False), ("ring_causal", True),
                         ("ulysses_causal", True)):
        with torch.no_grad():
            o, lse = attn_ops.flash_attention_with_lse(q, k, v,
                                                       causal=causal)
            grads = attn_ops.flash_attention_bwd(q, k, v, o, do, lse=lse,
                                                 causal=causal)
        whole = [torch.cat([r[name][i] for r in ranks], 2).cuda()
                 for i in range(4)]
        errs[name] = [ps_close(whole[0], o, KERNEL_TOL[torch.bfloat16],
                               f"pipe_seq {name} output")] + [
            ps_close(g, w, B7_TOL[torch.bfloat16], f"pipe_seq {name} d{x}")
            for g, w, x in zip(whole[1:], grads, "qkv")]
    return errs


def phase_pipe_seq():
    """Pipeline and sequence parallelism (module docstring, 24); returns
    the kernels line's rows."""
    with tempfile.TemporaryDirectory() as tmp:
        return ps_run(tmp)


def ps_run(tmp):
    """``phase_pipe_seq`` with ``tmp`` for the ranks' meeting, the
    one-process runs' weight changes and the ranks' results."""
    t_phase = time.perf_counter()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    T, V, L = PIPE_LM["max_len"], PIPE_LM["vocab_size"], PIPE_LM["num_layers"]
    H, D = PIPE_LM["num_heads"], PIPE_LM["d_model"] // PIPE_LM["num_heads"]
    samples = lm_samples(PS_BATCH * PS_STEPS, T, V, SEED + 25)
    # (a) one card: the partition's sequential path against the plain LM
    plain = TransformerLM(**PIPE_LM).build(
        "cuda", torch.Generator().manual_seed(SEED))
    piped = partition_pipeline(plain, 2)
    check([type(m).__name__ for m in piped.layers] ==
          ["LookupTable", "PositionalEmbedding", "GPipeSequential",
           "LayerNorm", "Linear", "LogSoftMax"]
          and piped.layers[2].num_stages == 2,
          f"pipe_seq: partition {[type(m).__name__ for m in piped.layers]}")
    init = ps_units(plain)
    plain_losses, plain_rec = ps_train(plain, samples, T)
    piped_losses, piped_rec = ps_train(piped, samples, T)
    check(piped_rec["b6"] == piped_rec["b6_lse"] == L * PS_STEPS
          and piped_rec["b7"] == 2 * L * PS_STEPS
          and only_route(attn_ops.flash_attention, "tc", piped_rec["b6"])
          and only_route(attn_ops.flash_attention_bwd, "tc",
                         piped_rec["b7"]),
          f"pipe_seq (a): launches {piped_rec}")
    check(piped_losses == plain_losses and len(plain_losses) == PS_STEPS
          and all(map(math.isfinite, plain_losses)),
          f"pipe_seq (a): sequential losses {piped_losses} are not the "
          f"plain LM's {plain_losses}")
    trained = ps_units(plain)
    check(all(torch.equal(a, b) for a, b in zip(
        trained, ps_units(piped))), "pipe_seq (a): the trained stack "
        "is not the plain LM's trained blocks bit for bit")
    torch.save(ps_delta(init, trained), os.path.join(tmp, "pipe_delta.pt"))
    del plain, piped, init, trained
    train.opt = None
    torch.cuda.empty_cache()
    # the dense LM at the transformer_lm width, for the seq-parallel LM
    dense = TransformerLM(**LM).build("cuda",
                                      torch.Generator().manual_seed(SEED))
    init = ps_units(dense)
    dense.eval()
    with torch.no_grad():
        dense_logp = dense(ps_tokens()).float()
    dense.train()
    seq_samples = lm_samples(PS_BATCH * PS_STEPS, LM["max_len"],
                             LM["vocab_size"], SEED + 28)
    dense_losses, dense_rec = ps_train(dense, seq_samples, LM["max_len"])
    torch.save(ps_delta(init, ps_units(dense)),
               os.path.join(tmp, "seq_delta.pt"))
    del dense, init
    train.opt = None
    torch.cuda.empty_cache()
    # (b) two gloo ranks on the one card
    ranks, wall = spawn_ranks("--pipe-seq-child", tmp, PS_TIMEOUT)
    seq_logp = [torch.load(os.path.join(tmp, f"seq_logp.rank{r}.pt"))
                for r in range(2)]
    fn_errs = ps_functions_check(tmp)
    for key, run in ranks[0]["runs"].items():
        sched, v = key.split("-")[0], int(key.split("-")[1])
        other = ranks[1]["runs"][key]
        check(run["losses"] == other["losses"],
              f"pipe_seq {key}: the ranks' losses differ {run['losses']} "
              f"{other['losses']}")
        check(len(run["losses"]) == PS_STEPS and max(
            abs(a - b) for a, b in zip(run["losses"], plain_losses))
            <= PS_LOSS_TOL, f"pipe_seq {key}: losses {run['losses']} vs "
            f"the one-card {plain_losses}")
        for r, rr in enumerate((run, other)):
            ps_weights_check(rr, f"pipe_seq {key} rank {r}")
        bubble = round(bubble_fraction(2, PS_MICRO, sched, v), 4)
        tbl = build_schedule(sched, 2, PS_MICRO, v)
        b6, lse, b7 = PS_PIPE_STEP[sched]
        for r, rr in enumerate((run, other)):
            d = rr["description"]
            check((d["pipe_stages"], d["pipe_schedule"],
                   d["pipe_virtual_stages"], d["pipe_microbatches"],
                   d["pipe_bubble_fraction"]) == (2, sched, v, PS_MICRO,
                                                  bubble)
                  and rr["bubble"] == [bubble] * PS_STEPS,
                  f"pipe_seq {key} rank {r}: description {d}, train "
                  f"track bubble {rr['bubble']} != {bubble}")
            want = (tbl.peak_inflight if sched == "gpipe"
                    else tbl.peak_inflight_per_device[r])
            check(rr["peak_stash"] == want, f"pipe_seq {key} rank {r}: "
                  f"stash peak {rr['peak_stash']} != {want}")
            check((rr["b6"], rr["b6_lse"], rr["b7"]) == (
                b6 * PS_STEPS, lse * PS_STEPS, b7 * PS_STEPS)
                and rr["routes"]["flash_attention"]["f32"] == 0
                and rr["routes"]["flash_attention_bwd"]["f32"] == 0,
                f"pipe_seq {key} rank {r}: launches {rr}")
        check(max(run["peak_stash"], other["peak_stash"]) ==
              tbl.peak_inflight, f"pipe_seq {key}: stash peaks")
    seq = [r["seq"] for r in ranks]
    check(seq[0]["losses"] == seq[1]["losses"] and max(
        abs(a - b) for a, b in zip(seq[0]["losses"], dense_losses))
        <= PS_LOSS_TOL, f"pipe_seq seq: losses {seq[0]['losses']} "
        f"{seq[1]['losses']} vs the dense {dense_losses}")
    for r in range(2):
        ps_weights_check(seq[r], f"pipe_seq seq rank {r}")
        b6, b7 = PS_SEQ_STEP[r]
        check((seq[r]["b6"], seq[r]["b6_lse"], seq[r]["b7"]) ==
              (b6 * PS_STEPS, b6 * PS_STEPS, b7 * PS_STEPS),
              f"pipe_seq seq rank {r}: launches {seq[r]}")
    check(torch.equal(seq_logp[0], seq_logp[1]), "pipe_seq seq: the ranks' "
          "log-probs differ")
    logp_err = ps_close(seq_logp[0].cuda(), dense_logp,
                        KERNEL_TOL[torch.bfloat16], "pipe_seq seq log-probs")
    # the kernels at this phase's shapes
    b6p = flash_case(PS_MICRO, H, T, T, D, torch.bfloat16, True,
                     torch.Generator().manual_seed(SEED + 29), with_lse=True)
    b7p = b7_case(PS_MICRO, H, T, T, D, torch.bfloat16, True,
                  torch.Generator(device="cuda").manual_seed(SEED + 29))
    Hs, Ts, Ds = LM["num_heads"], LM["max_len"] // 2, 64
    b6r = flash_case(PS_BATCH, Hs, Ts, Ts, Ds, torch.bfloat16, False,
                     torch.Generator().manual_seed(SEED + 30), with_lse=True)
    b7r = b7_case(PS_BATCH, Hs, Ts, Ts, Ds, torch.bfloat16, False,
                  torch.Generator(device="cuda").manual_seed(SEED + 30))
    B, Hf, Tf, Df = PS_FN_SHAPE
    b6u, b7u = flash_pair_cases(B, Hf // 2, Tf, Df, SEED + 31)
    for c in (b6p, b7p, b6r, b7r):
        check(c["ok"], f"pipe_seq kernel case {c}")
    pipe_b6 = sum(r["runs"][k]["b6"] for r in ranks for k in r["runs"])
    pipe_b7 = sum(r["runs"][k]["b7"] for r in ranks for k in r["runs"])
    fl = [r["function_launches"]["ulysses_causal"] for r in ranks]
    emit({"phase": "pipe_seq", "gpu": gpu_line(), "config": PIPE_LM,
          "seq_config": LM, "batch": PS_BATCH, "steps": PS_STEPS,
          "microbatches": PS_MICRO, "one_card": {
              "plain": plain_rec, "partitioned": piped_rec},
          "dense_lm": dense_rec, "ranks": ranks, "spawn_wall_s": wall,
          "seq_logp_max_abs_err": logp_err, "function_errs": fn_errs,
          "b6_pipe": b6p, "b7_pipe": b7p, "b6_ring": b6r, "b7_ring": b7r,
          "b6_ulysses": b6u, "b7_ulysses": b7u,
          "phase_s": time.perf_counter() - t_phase})
    tc6 = {"tc": 0, "f32": 0}
    return [
        kernel_row(b6p, "flash_attention", *B6_SRC, pipe_b6,
                   "pipe_seq pipeline (both ranks, 3 schedules)",
                   {**tc6, "tc": pipe_b6}),
        kernel_row(b7p, "flash_attention_bwd", *B7_SRC, pipe_b7,
                   "pipe_seq pipeline (both ranks, 3 schedules)",
                   {**tc6, "tc": pipe_b7}),
        kernel_row(b6r, "flash_attention", *B6_SRC,
                   seq[0]["b6"] + seq[1]["b6"],
                   "pipe_seq ring (the seq-parallel LM, both ranks)",
                   {**tc6, "tc": seq[0]["b6"] + seq[1]["b6"]}),
        kernel_row(b7r, "flash_attention_bwd", *B7_SRC,
                   seq[0]["b7"] + seq[1]["b7"],
                   "pipe_seq ring (the seq-parallel LM, both ranks)",
                   {**tc6, "tc": seq[0]["b7"] + seq[1]["b7"]}),
        kernel_row(b6u, "flash_attention", *B6_SRC, fl[0][0] + fl[1][0],
                   "pipe_seq ulysses_attention (both ranks)",
                   {**tc6, "tc": fl[0][0] + fl[1][0]}),
        kernel_row(b7u, "flash_attention_bwd", *B7_SRC, fl[0][1] + fl[1][1],
                   "pipe_seq ulysses_attention (both ranks)",
                   {**tc6, "tc": fl[0][1] + fl[1][1]})]


# ---------------------------------------------------------------------------
# layouts: the bench LM trained, scored and decoded under the mesh layouts
# ---------------------------------------------------------------------------

LY_LAYOUTS = ((1, 2, 2), (2, 2, 1))
LY_BATCH = 16
LY_STEPS = 5
LY_TIMEOUT = 600
#: a rank's parameter elements by the role table at the default min_size
#: (the reference's table over the LM's 134 leaves, 58,282,240 elements)
LY_LOCAL = {(1, 2, 2): 14635264, (2, 2, 1): 29184256}
#: (B6 launch shape, B6 launches with the log-sum-exp, B7 launches) a rank
#: makes in one step: the rank's rows (16 over data x fsdp) and heads (8
#: over tp), one B6 a layer and one B7 call (2 launches) a layer
LY_STEP = {(1, 2, 2): ((8, 4, 512, 64), 8, 16),
           (2, 2, 1): ((4, 8, 512, 64), 8, 16)}
#: the Engine's collectives a rank calls in one step, by kind, written
#: before the first run from the plan (parallel/mesh_plan.py): the
#: parameters gathered at use, one all-gather a unit of the model (the
#: token table, the position table, each of the 8 blocks and the head:
#: 11; the final LayerNorm's leaves are replicated) and reduce-scattered
#: back alike, and gathered again in the backward where a unit saved a
#: gathered weight (each block and the head, 9); under tp, 33
#: output gathers
#: and 33 input-gradient all-reduces (2 an attention, 2 a feed-forward, 1
#: the head) and one bias-slice gather an attention; the batch axes' sum
#: of the rest: one all-reduce a set of axes still to sum over (the
#: replicated leaves and the loss; under (2,2,1) also the fsdp leaves over
#: data)
LY_COLLECTIVES = {
    (1, 2, 2): {"all_gather": {"params": 11, "params_bwd": 9, "tp_out": 33,
                               "tp_bias": 8},
                "all_reduce": {"tp_in": 33, "grads": 1},
                "reduce_scatter": {"grads": 11}},
    (2, 2, 1): {"all_gather": {"params": 11, "params_bwd": 9},
                "all_reduce": {"grads": 2},
                "reduce_scatter": {"grads": 11}}}
LY_PREDICT_ROWS = 8
LY_PREDICT_TOL = 0.0625         # one bf16 ulp at |log-prob| near 10
LY_PREDICT_EVERY = 16           # positions kept for the comparison
LY_PROMPT = 8
LY_NEW = 5
LY_CACHE = 64
LY_DECODE_TOL = 1e-4
LY_TP_STEPS = 3
LY_TP_BATCH = 32
LY_TP_TOL = 1e-5
LY_TP_METHODS = {"adam": lambda: Adam(1e-2), "sgd": lambda: SGD(0.1)}


def ly_data():
    """The LM's samples, the scored sequences, the decode prompts and the
    TensorParallel MLP's data (tests/test_multihost_tp.py's)."""
    T, V = LM["max_len"], LM["vocab_size"]
    samples = lm_samples(LY_BATCH * LY_STEPS, T, V, SEED)
    rows = np.random.default_rng(SEED + 41).integers(
        0, V, (LY_PREDICT_ROWS, T)).astype(np.int32)
    prompts = np.random.default_rng(SEED + 42).integers(
        0, V, (LY_PROMPT, LY_PROMPT)).astype(np.int32)
    r = np.random.default_rng(7)
    ys = r.integers(0, 4, size=LY_TP_BATCH * LY_TP_STEPS)
    centers = r.normal(0, 2.0, size=(4, 16)).astype(np.float32)
    xs = (centers[ys] + r.normal(0, 0.3, size=(len(ys), 16))).astype(
        np.float32)
    tp = [Sample.from_ndarray(x, np.int32(y)) for x, y in zip(xs, ys)]
    return samples, rows, prompts, tp


def ly_tp_model():
    return nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4),
                         nn.LogSoftMax()).build(
        "cuda", torch.Generator().manual_seed(SEED + 43))


def ly_tp_rule(path, leaf):
    """tests/test_multihost_tp.py's rule: the output-feature axis of 2-D
    weights over 'model'."""
    if leaf.ndim == 2 and leaf.shape[-1] % 2 == 0:
        return (None, "model")
    return ()


def ly_tp_train(samples, strategy=None):
    """The MLP's ``LY_TP_STEPS`` steps with each method of
    ``LY_TP_METHODS``: one process, or this rank's under a fresh
    ``strategy()``; {method: {"losses", "weights"}}, the weights gathered
    whole (every rank calls it).  SGD's weights see the gradients' scale,
    which Adam's update all but divides out."""
    out = {}
    for name, method in LY_TP_METHODS.items():
        model = ly_tp_model()
        losses = train(model, samples, LY_TP_STEPS,
                       LY_TP_BATCH // Engine.group_size() if strategy else
                       LY_TP_BATCH, distributed=strategy is not None,
                       device=None if strategy else "cuda",
                       criterion=nn.ClassNLLCriterion(), method=method(),
                       strategy=strategy and strategy())
        tree, _ = to_reference_tree(model)
        out[name] = {"losses": losses,
                     "weights": [np.asarray(a).ravel() for a in
                                 ly_leaves(tree)]}
        train.opt = None
    return out


def ly_leaves(tree):
    """A reference tree's leaves, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in ly_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in ly_leaves(v)]
    return [tree]


@contextlib.contextmanager
def ly_float32():
    """Float32 compute, TF32 off, inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_policy(DTypePolicy(compute_dtype=torch.float32))
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
        set_policy(DTypePolicy(compute_dtype=torch.bfloat16))


@contextlib.contextmanager
def launch_counts(module, name, key=lambda q, *a: tuple(q.shape)):
    """``module.name`` (a kernel's wrapper as a caller imported it)
    wrapped to count each call under ``key(*args)`` (default: the first
    operand's shape); yields the Counter."""
    fn = getattr(module, name)
    seen = collections.Counter()

    def wrapped(*a, **kw):
        seen[key(*a)] += 1
        return fn(*a, **kw)
    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def zero_b8():
    dec_ops.decode_attention.launches = 0
    zero_routes(dec_ops.decode_attention)


def ly_rank_diff(units):
    """max |this rank's weights - rank 0's| (0.0: bit-equal)."""
    import torch.distributed as dist
    x = torch.cat(units)
    ref = x.clone()
    dist.broadcast(ref, 0)
    return float((x - ref).abs().max())


def ly_train(sizes, samples, ref):
    """One layout's run on this rank: the LM from the seed, ``LY_STEPS``
    steps under ``LayoutSharding``; the record of the gates."""
    from bigdl_torch.nn import attention as attn_mod
    model = TransformerLM(**LM).build("cuda",
                                      torch.Generator().manual_seed(SEED))
    init = ps_units(model)
    strat = LayoutSharding(model)
    on_step, step_ms = ps_step_ms(LY_STEPS)
    zero_flash()
    Engine.clear_counts()
    hops_mod.host_copies.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with launch_counts(attn_mod, "flash_attention") as shapes:
        losses = train(model, samples, LY_STEPS,
                       LY_BATCH // Engine.group_size(), distributed=True,
                       criterion=nn.TimeDistributedCriterion(
                           nn.ClassNLLCriterion(), size_average=True),
                       method=SGD(LM_LR, momentum=0.9), on_step=on_step,
                       strategy=strat)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fwd, bwd = flash_counts()
    coll = Engine.collectives()
    plan = model._layout_plan
    state = train.opt._final_state
    with strat.whole(model):
        trained = ps_units(model)
    rec = {"layout": list(sizes), "losses": losses,
           "host_step_ms": step_ms(), "run_s": run_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "gathered_bytes_max_unit": max(plan.gathered_bytes()),
           "gathered_bytes_all_units": sum(plan.gathered_bytes()),
           "local_elements": plan.local_elements(),
           "state_elements": sum(t.numel() for t in state["velocity"]),
           "tp_modules": len(plan.tp_modules()),
           "b6": fwd, "b6_lse": attn_ops.flash_attention.lse_launches,
           "b7": bwd, "routes": flash_routes(),
           "b6_shapes": sorted(shapes), "collectives": coll,
           "host_copies": dict(hops_mod.host_copies),
           "delta_errs": ps_delta_errs(init, trained, ref),
           "rank_max_abs_diff": ly_rank_diff(trained)}
    del init, trained
    return model, strat, rec


def ly_score_and_decode(model, strat, rows, prompts, out_dir, rank):
    """(1,2,2) after training: Predictor under the strategy on
    ``LY_PREDICT_ROWS`` sequences, then ``cached_generate(mesh=)`` in
    float32 (compared) and in bf16 (timed); rank 0 saves what the parent
    compares."""
    from bigdl_torch.nn import attention as attn_mod
    rec = {}
    zero_flash()
    with launch_counts(attn_mod, "flash_attention") as shapes:
        logp = Predictor(model, batch_size=LY_PREDICT_ROWS,
                         strategy=strat).predict(rows)
    rec["predict"] = {"b6": attn_ops.flash_attention.launches,
                      "b6_lse": attn_ops.flash_attention.lse_launches,
                      "b6_shapes": sorted(shapes),
                      "routes": flash_routes()}
    tree, _ = to_reference_tree(model)
    steps = LY_PROMPT + LY_NEW - 1
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        zero_b8()
        ctx = ly_float32() if dtype == torch.float32 else \
            contextlib.nullcontext()
        with ctx, launch_counts(dec_mod, "decode_attention") as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, lrows = dec_mod.cached_generate_rows(
                model, prompts, LY_NEW, LY_CACHE, cache_dtype=dtype,
                mesh=Engine.mesh())
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        rec["decode_" + name] = {
            "b8": dec_ops.decode_attention.launches,
            "routes": dict(dec_ops.decode_attention.route_launches),
            "b8_shapes": sorted(seen), "steps": steps,
            "ms_per_step": 1e3 * dt / steps}
        if rank == 0 and name == "f32":
            torch.save({"tokens": toks, "rows": np.stack(lrows)},
                       os.path.join(out_dir, "ly_decode.pt"))
    if rank == 0:
        torch.save({"tree": tree, "logp": logp[:, ::LY_PREDICT_EVERY]},
                   os.path.join(out_dir, "ly_trained.pt"))
    del tree, logp
    return rec


def layouts_child(out_dir):
    """One of the four ranks of ``layouts``: (1,2,2) then (2,2,1), each a
    group of its own, then the TensorParallel MLP on a model x data
    mesh."""
    import torch.distributed as dist
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    samples, rows, prompts, tp_samples = ly_data()
    ref = torch.load(os.path.join(out_dir, "ly_delta.pt"))
    one_tp = torch.load(os.path.join(out_dir, "ly_tp.pt"), weights_only=False)
    runs = {}
    for i, sizes in enumerate(LY_LAYOUTS):
        os.environ["BIGDL_TORCH_COORDINATOR"] = f"file://{out_dir}/store{i}"
        Engine.init(device="cuda:0", backend="gloo",
                    mesh_shape=MeshLayout(*sizes).shape())
        model, strat, rec = ly_train(sizes, samples, ref)
        if sizes == (1, 2, 2):
            rec.update(ly_score_and_decode(model, strat, rows, prompts,
                                           out_dir, rank))
        runs["x".join(map(str, sizes))] = rec
        del model, strat
        train.opt = None
        torch.cuda.empty_cache()
        dist.barrier()
        Engine.reset()
    os.environ["BIGDL_TORCH_COORDINATOR"] = f"file://{out_dir}/store_tp"
    Engine.init(device="cuda:0", backend="gloo",
                mesh_shape={"model": 2, "data": 2})
    with ly_float32():
        tp = ly_tp_train(tp_samples, lambda: TensorParallel(rule=ly_tp_rule))
    emit({"rank": rank, "world": 4, "runs": runs,
          "tp": {"runs": {k: {"losses": v["losses"], "weights_err": float(
              max(np.abs(a - b).max() for a, b in zip(
                  v["weights"], one_tp[k]["weights"])))}
              for k, v in tp.items()},
              "batch_group": Engine.group_size()}})
    dist.barrier()
    Engine.reset()
    return 0


def phase_layouts():
    """The mesh layouts (module docstring, 25); returns the kernels line's
    rows."""
    with tempfile.TemporaryDirectory() as tmp:
        return ly_run(tmp)


def ly_checks(ranks, one):
    """Gates (a) to (e) of each layout on each rank, then scoring, decoding
    and TensorParallel against the one-process runs ``one``."""
    for sizes in LY_LAYOUTS:
        key = "x".join(map(str, sizes))
        shape, b6, b7 = LY_STEP[sizes]
        want = {k: {n: c * LY_STEPS for n, c in v.items()}
                for k, v in LY_COLLECTIVES[sizes].items()}
        for r, rr in enumerate(ranks):
            run, what = rr["runs"][key], f"layouts {key} rank {r}"
            check(run["local_elements"] == run["state_elements"] ==
                  LY_LOCAL[sizes], f"{what} (a): local parameter and state "
                  f"elements {run['local_elements']} "
                  f"{run['state_elements']} != {LY_LOCAL[sizes]}")
            check((run["b6"], run["b6_lse"], run["b7"]) ==
                  (b6 * LY_STEPS, b6 * LY_STEPS, b7 * LY_STEPS)
                  and run["b6_shapes"] == [list(shape)]
                  and only_route_counts(run["routes"]),
                  f"{what} (d): launches {run['b6']} {run['b6_lse']} "
                  f"{run['b7']} at {run['b6_shapes']}, routes "
                  f"{run['routes']}")
            check({k: v for k, v in run["collectives"].items() if v} == want,
                  f"{what} (e): collectives {run['collectives']} != {want}")
            check(run["rank_max_abs_diff"] == 0.0, f"{what} (b): the "
                  f"gathered weights differ from rank 0's by up to "
                  f"{run['rank_max_abs_diff']}")
            check(max(run["delta_errs"]) <= PS_DELTA_TOL, f"{what} (c): "
                  f"|Δ - Δref| / |Δref| by unit {run['delta_errs']} beyond "
                  f"{PS_DELTA_TOL}")
            check(len(run["losses"]) == LY_STEPS and all(
                map(math.isfinite, run["losses"])), f"{what}: losses "
                f"{run['losses']}")
    for r, rr in enumerate(ranks):
        run = rr["runs"]["1x2x2"]
        p = run["predict"]
        check((p["b6"], p["b6_lse"]) == (LM["num_layers"], 0)
              and p["b6_shapes"] == [[LY_PREDICT_ROWS // 2,
                                      LM["num_heads"] // 2, LM["max_len"],
                                      64]],
              f"layouts rank {r}: scoring launches {p}")
        steps = LY_PROMPT + LY_NEW - 1
        for name in ("f32", "bf16"):
            d = run["decode_" + name]
            check(d["b8"] == d["routes"][name] == steps * LM["num_layers"]
                  and d["b8_shapes"] == [[LY_PROMPT // 2,
                                          LM["num_heads"] // 2, 1, 64]],
                  f"layouts rank {r}: decode {name} launches {d}")
        check(rr["tp"]["batch_group"] == 2, f"layouts TensorParallel rank "
              f"{r}: batch group {rr['tp']['batch_group']}")
        for name, run in rr["tp"]["runs"].items():
            want = one["tp"][name]["losses"]
            check(len(run["losses"]) == LY_TP_STEPS and max(
                abs(a - b) for a, b in zip(run["losses"], want))
                <= LY_TP_TOL and run["weights_err"] <= LY_TP_TOL,
                f"layouts TensorParallel {name} rank {r}: losses "
                f"{run['losses']} vs one process's {want}, weights off by "
                f"{run['weights_err']}")


def only_route_counts(routes):
    """Every B6 and B7 launch of a run on ``"tc"``."""
    return (routes["flash_attention"].get("f32", 0) == 0
            and routes["flash_attention_bwd"].get("f32", 0) == 0)


def ly_run(tmp):
    """``phase_layouts`` with ``tmp`` for the ranks' meeting, the
    one-process run's weight changes and the ranks' results."""
    t_phase = time.perf_counter()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    H = LM["num_heads"]
    samples, rows, prompts, tp_samples = ly_data()
    # the one-process run on the card
    plain = TransformerLM(**LM).build("cuda",
                                      torch.Generator().manual_seed(SEED))
    init = ps_units(plain)
    plain_losses, plain_rec = ps_train(plain, samples, LM["max_len"])
    torch.save(ps_delta(init, ps_units(plain)),
               os.path.join(tmp, "ly_delta.pt"))
    del plain, init
    train.opt = None
    torch.cuda.empty_cache()
    with ly_float32():
        one_tp = ly_tp_train(tp_samples)
    torch.save(one_tp, os.path.join(tmp, "ly_tp.pt"))
    # four gloo ranks on the one card
    ranks, wall = spawn_ranks("--layouts-child", tmp, LY_TIMEOUT, n=4)
    # the one-process Predictor and float32 decode on the gathered weights
    saved = torch.load(os.path.join(tmp, "ly_trained.pt"),
                       weights_only=False)
    one = TransformerLM(**LM).build("cuda")
    load_reference_tree(one, saved["tree"])
    del saved["tree"]
    logp = Predictor(one, batch_size=LY_PREDICT_ROWS,
                     device="cuda").predict(rows)
    predict_err = float(np.abs(logp[:, ::LY_PREDICT_EVERY]
                               - saved["logp"]).max())
    del logp
    mesh_dec = torch.load(os.path.join(tmp, "ly_decode.pt"),
                          weights_only=False)
    with ly_float32():
        toks, lrows = dec_mod.cached_generate_rows(
            one, prompts, LY_NEW, LY_CACHE, cache_dtype=torch.float32)
    decode_err = float(np.abs(np.stack(lrows) - mesh_dec["rows"]).max())
    del one
    torch.cuda.empty_cache()
    emit({"phase": "layouts", "part": "ranks", "gpu": gpu_line(),
          "config": LM, "batch": LY_BATCH, "steps": LY_STEPS,
          "one_process": plain_rec, "ranks": ranks, "spawn_wall_s": wall,
          "predict_max_abs_err": predict_err,
          "decode_tokens_equal": bool(np.array_equal(toks,
                                                     mesh_dec["tokens"])),
          "decode_max_abs_err": decode_err, "tp_one_process": {
              k: v["losses"] for k, v in one_tp.items()}})
    ly_checks(ranks, {"tp": one_tp})
    check(predict_err <= LY_PREDICT_TOL, f"layouts: Predictor under "
          f"(1,2,2) off the one-process Predictor by {predict_err}")
    check(np.array_equal(toks, mesh_dec["tokens"]) and
          decode_err <= LY_DECODE_TOL, f"layouts: float32 decode on the "
          f"mesh: tokens {mesh_dec['tokens'].tolist()} vs "
          f"{toks.tolist()}, log-prob rows off by {decode_err}")
    # the kernels at this phase's shapes
    b6a, b7a = flash_pair_cases(8, H // 2, LM["max_len"], 64, SEED + 44)
    b6b, b7b = flash_pair_cases(4, H, LM["max_len"], 64, SEED + 45)
    b6p = flash_case(LY_PREDICT_ROWS // 2, H // 2, LM["max_len"],
                     LM["max_len"], 64, torch.bfloat16, True,
                     torch.Generator().manual_seed(SEED + 46))
    gen = torch.Generator().manual_seed(SEED + 47)
    b8f = decode_case(LY_PROMPT // 2, H // 2, LY_CACHE, 64, torch.float32,
                      gen)
    b8b = decode_case(LY_PROMPT // 2, H // 2, LY_CACHE, 64, torch.bfloat16,
                      gen)
    for c in (b6p, b8f, b8b):
        check(c["ok"], f"layouts kernel case {c}")
    emit({"phase": "layouts", "gpu": gpu_line(),
          "host_step_ms": {k: [r["runs"][k]["host_step_ms"] for r in ranks]
                           for k in ranks[0]["runs"]},
          "max_memory_allocated": {
              k: [r["runs"][k]["max_memory_allocated"] for r in ranks]
              for k in ranks[0]["runs"]},
          "gathered_bytes": {
              k: {n: ranks[0]["runs"][k]["gathered_bytes_" + n]
                  for n in ("max_unit", "all_units")}
              for k in ranks[0]["runs"]},
          "host_copies": [{k: r["runs"][k]["host_copies"]
                           for k in r["runs"]} for r in ranks],
          "decode_ms_per_step": {
              n: [r["runs"]["1x2x2"]["decode_" + n]["ms_per_step"]
                  for r in ranks] for n in ("f32", "bf16")},
          "one_process_host_step_ms": plain_rec["host_step_ms"],
          "b6_122": b6a, "b7_122": b7a, "b6_221": b6b, "b7_221": b7b,
          "b6_scoring": b6p, "b8_f32": b8f, "b8_bf16": b8b,
          "phase_s": time.perf_counter() - t_phase})
    tc = {"tc": 0, "f32": 0}

    def total(key, field, sub=None):
        return sum((r["runs"][key][sub] if sub else r["runs"][key])[field]
                   for r in ranks)
    dec = {n: total("1x2x2", "b8", "decode_" + n) for n in ("f32", "bf16")}
    return [
        kernel_row(b6a, "flash_attention", *B6_SRC, total("1x2x2", "b6"),
                   "layouts (1,2,2) LM steps (4 ranks)",
                   {**tc, "tc": total("1x2x2", "b6")}),
        kernel_row(b7a, "flash_attention_bwd", *B7_SRC,
                   total("1x2x2", "b7"), "layouts (1,2,2) LM steps (4 ranks)",
                   {**tc, "tc": total("1x2x2", "b7")}),
        kernel_row(b6b, "flash_attention", *B6_SRC, total("2x2x1", "b6"),
                   "layouts (2,2,1) LM steps (4 ranks)",
                   {**tc, "tc": total("2x2x1", "b6")}),
        kernel_row(b7b, "flash_attention_bwd", *B7_SRC,
                   total("2x2x1", "b7"), "layouts (2,2,1) LM steps (4 ranks)",
                   {**tc, "tc": total("2x2x1", "b7")}),
        kernel_row(b6p, "flash_attention", *B6_SRC,
                   total("1x2x2", "b6", "predict"),
                   "layouts (1,2,2) Predictor (4 ranks)",
                   {**tc, "tc": total("1x2x2", "b6", "predict")}),
        {**kernel_row(b8f, "decode_attention", *B8_SRC, dec["f32"],
                      "layouts (1,2,2) cached_generate float32 (4 ranks)",
                      {"f32": dec["f32"], "bf16": 0}),
         "floor_ms": b8f["floor_ms"], "splits": b8f["splits"]},
        {**kernel_row(b8b, "decode_attention", *B8_SRC, dec["bf16"],
                      "layouts (1,2,2) cached_generate bf16 (4 ranks)",
                      {"f32": 0, "bf16": dec["bf16"]}),
         "floor_ms": b8b["floor_ms"], "splits": b8b["splits"]}]


# -- 26. serve_layouts ---------------------------------------------------------

SL_TIMEOUT = 600
#: the router's scoring requests: (count, shortest, longest) in tokens
SL_REQUESTS = (32, 100, 512)
#: the float32 router's requests and batch cap
SL_F32_REQUESTS = (8, 100, 512)
SL_F32_BATCH = 2
SL_F32_TOL = 1e-4
#: requests queued behind the scale-down, then sent after the loss
SL_SCALE = 8
SL_LOSS = 16
#: the layout server's requests (count, shortest, longest) and its one
#: sequence bucket: under fsdp every forward gathers the whole LM's
#: float32 parameters over gloo, so its ladder stays short
SL_SERVER = (12, 100, 128)
SL_SERVER_BUCKETS = SEQ_BUCKETS[:1]
#: the decode engine on (1,2,2): slots, cache page, sequences, prompt
#: lengths and new tokens
SL_SLOTS = 8
SL_PAGE = 16
SL_SEQS = 12
#: the float32 run's sequences (its gates: tokens and rows), fewer: every
#: prompt position is a step of about 60 gloo collectives
SL_F32_SEQS = 6
SL_PROMPT = (8, 16)
SL_NEW = 8


def sl_requests(spec, seed):
    n, lo, hi = spec
    r = np.random.default_rng(seed)
    return [r.integers(0, LM["vocab_size"], r.integers(lo, hi + 1))
            .astype(np.int64) for _ in range(n)]


def sl_prompts():
    r = np.random.default_rng(SEED + 63)
    return [r.integers(0, LM["vocab_size"], r.integers(SL_PROMPT[0],
                                                       SL_PROMPT[1] + 1))
            .astype(np.int32) for _ in range(SL_SEQS)]


def sl_b6_counts():
    from bigdl_torch.nn import attention as attn_mod
    return launch_counts(attn_mod, "flash_attention")


def sl_b8_counts():
    # (q's shape, the cache's length)
    return launch_counts(dec_mod, "decode_attention",
                         lambda q, kn, vn, kc, *a: tuple(q.shape)
                         + (int(kc.shape[2]),))


def sl_one_predictor(solo, seed):
    """The one-process Predictor on this rank (rank 0) alone: the LM from
    ``seed``, unsharded, on the solo mesh (a group of one)."""
    one = TransformerLM(**LM).build("cuda", torch.Generator().manual_seed(
        seed))
    with Engine.pinned(solo):
        return one, Predictor(one, batch_size=MAX_BATCH, device="cuda")


def sl_errors(pairs, preds):
    """max |answer - one-process Predictor| by version over ``pairs`` of
    (request, answer, version), each request padded to its bucket; the
    predictors batch the requests of one bucket and version."""
    worst = {}
    groups = collections.defaultdict(list)
    for x, out, v in pairs:
        groups[(out.shape[0], v)].append((x, out))
    for (T, v), items in sorted(groups.items()):
        want = preds[v][1].predict(np.stack([pad_tail(x, T)
                                             for x, _ in items]))
        err = max(float(np.abs(out - w).max()) for (_, out), w
                  in zip(items, want))
        worst[v] = max(worst.get(v, 0.0), err)
        del want
    return worst


def sl_router(rank, solo, f32):
    """(R) the router over ranks {0,1} and {2,3}, (1,1,2) members; the
    bf16 run adds the scale and loss drills.  Every rank returns its B6
    launches; rank 0 also the routing, the drills, the errors against the
    one-process Predictor and the batches sent to each member."""
    spec = SL_F32_REQUESTS if f32 else SL_REQUESTS
    xs = sl_requests(spec, SEED + 60 + int(f32))
    lm = TransformerLM(**LM).build("cuda", torch.Generator().manual_seed(
        SEED))
    zero_flash()
    hops_mod.host_copies.clear()
    rec = {}
    with sl_b6_counts() as shapes:
        router = TopologyRouter(
            lm, layout=MeshLayout(1, 1, 2), replicas=2,
            max_batch=SL_F32_BATCH if f32 else MAX_BATCH, max_wait_ms=5,
            seq_buckets=SEQ_BUCKETS,
            example=np.zeros((SEQ_BUCKETS[0],), np.int64),
            device="cuda").start()
        if rank == 0:
            t0 = time.perf_counter()
            pairs = [(x, h.result(300), 1) for x, h in
                     [(x, router.submit(x)) for x in xs]]
            rec["serve_s"] = time.perf_counter() - t0
            rec["tokens"] = int(sum(len(x) for x in xs))
            st = router.stats()
            rec["routed"] = st["router"]["routed"]
            if not f32:
                rec["stats_router"] = st["router"]
                # scale down with requests queued, then back up
                short = [x[:SEQ_BUCKETS[0]] for x in xs[:SL_SCALE]]
                queued = [(x, router.submit(x)) for x in short]
                rec["scale_down"] = router.scale_to(1)
                pairs += [(x, h.result(300), 1) for x, h in queued]
                pairs += [(x, router.predict(x, timeout=300), 1)
                          for x in short]
                rec["live_after_down"] = router.stats()["replicas_live"]
                rec["scale_up"] = router.scale_to(2)
                # member 0 lost: the next requests all go to member 1
                router._members[0]._mark_unhealthy(
                    ReplicaLostError("drill: member 0 lost"))
                before = list(router._routed)
                lost = [x[:SEQ_BUCKETS[0]] for x in
                        sl_requests((SL_LOSS, 100, 128), SEED + 62)]
                pairs += [(x, h.result(300), 1) for x, h in
                          [(x, router.submit(x)) for x in lost]]
                rec["routed_after_loss"] = [
                    a - b for a, b in zip(router._routed, before)]
                rec["healthy_after_loss"] = router.healthy()
            rec["batches"] = [router._leads[i].counts.get("batch", 0)
                              for i in range(2)]
            rec["answered"] = len(pairs)
        router.stop()
    torch.cuda.synchronize()
    rec["b6"] = attn_ops.flash_attention.launches
    rec["b6_lse"] = attn_ops.flash_attention.lse_launches
    rec["routes"] = flash_routes()
    rec["b6_shapes"] = [[list(k), n] for k, n in sorted(shapes.items())]
    rec["host_copies"] = dict(hops_mod.host_copies)
    if rank == 0:
        preds = {1: sl_one_predictor(solo, SEED)}
        rec["max_abs_err"] = sl_errors(pairs, preds)[1]
        del pairs, preds
    del lm, router
    torch.cuda.empty_cache()
    return rec


def sl_server(rank, solo):
    """(S) ``InferenceServer(mesh=)`` on the Engine's (1,2,2) over the four
    ranks, ``replicas=2``, a swap to a second LM while two clients send."""
    xs = sl_requests(SL_SERVER, SEED + 64)
    lm = TransformerLM(**LM).build("cuda", torch.Generator().manual_seed(
        SEED))
    zero_flash()
    hops_mod.host_copies.clear()
    rec = {}
    with sl_b6_counts() as shapes:
        server = InferenceServer(
            lm, mesh=Engine.mesh(), strategy=LayoutSharding(lm), replicas=2,
            max_batch=MAX_BATCH, max_wait_ms=5,
            seq_buckets=SL_SERVER_BUCKETS,
            example=np.zeros((SEQ_BUCKETS[0],), np.int64),
            device="cuda").start()
        if rank == 0:
            pairs, lock, swapped = [], threading.Lock(), threading.Event()
            second = TransformerLM(**LM).build(
                "cuda", torch.Generator().manual_seed(SEED + 1))

            def client(rows):
                # closed loop: a pass while the swap runs, one after it
                for k in range(2):
                    if k:
                        swapped.wait()
                    for x in rows:
                        h = server.submit(x)
                        with lock:
                            pairs.append((x, h.result(300), h.version))
            ts = [threading.Thread(target=client, args=(xs[k::2],))
                  for k in range(2)]
            for t in ts:
                t.start()
            while len(pairs) < 2:
                time.sleep(0.01)
            rec["swapped_to"] = server.swap(second)
            swapped.set()
            for t in ts:
                t.join()
            st = server.stats()
            rec.update(answered=len(pairs), batch_errors=st["batch_errors"],
                       versions=sorted({v for _, _, v in pairs}),
                       messages=st["mesh"]["messages"])
            rec["batches"] = st["mesh"]["messages"]["batch"]
        server.stop()
    torch.cuda.synchronize()
    rec["b6"] = attn_ops.flash_attention.launches
    rec["b6_lse"] = attn_ops.flash_attention.lse_launches
    rec["routes"] = flash_routes()
    rec["b6_shapes"] = [[list(k), n] for k, n in sorted(shapes.items())]
    rec["host_copies"] = dict(hops_mod.host_copies)
    if rank == 0:
        preds = {1: sl_one_predictor(solo, SEED),
                 2: sl_one_predictor(solo, SEED + 1)}
        rec["max_abs_err"] = sl_errors(pairs, preds)
        del pairs, preds, second
    del lm, server
    torch.cuda.empty_cache()
    return rec


def sl_sampled(eng, seen):
    """``eng._sample`` wrapped to keep each sequence's log-prob rows, by
    its request."""
    fn = eng._sample

    def wrapped(seq, row):
        seen.setdefault(id(seq.req), []).append(np.array(row, np.float32))
        return fn(seq, row)
    eng._sample = wrapped


def sl_decode(rank):
    """(D) ``DecodeEngine(mesh=)`` on the Engine's (1,2,2): float32 against
    one process (rank 0), then bf16, timed."""
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ctx = ly_float32() if dtype == torch.float32 else \
            contextlib.nullcontext()
        prompts = sl_prompts()[:SL_F32_SEQS if name == "f32" else SL_SEQS]
        rec = {}
        with ctx:
            lm = TransformerLM(**LM).build(
                "cuda", torch.Generator().manual_seed(SEED))
            zero_b8()
            hops_mod.host_copies.clear()
            with sl_b8_counts() as shapes:
                eng = DecodeEngine(lm, mesh=Engine.mesh(), slots=SL_SLOTS,
                                   page=SL_PAGE, cache_dtype=dtype,
                                   device="cuda").start()
                if rank == 0:
                    rows = {}
                    sl_sampled(eng, rows)
                    t0 = time.perf_counter()
                    hs = [eng.submit(p, SL_NEW) for p in prompts]
                    toks = [h.result(300) for h in hs]
                    rec["wall_s"] = time.perf_counter() - t0
                    st = eng.stats()
                    rec.update({k: st[k] for k in (
                        "decode_steps", "prefill_steps", "tokens_out",
                        "tokens_per_s", "cache_len", "cache_grows")})
                    rec["graphs"] = st["graphs"]
                    rec["prefill_positions"] = st["mesh"][
                        "prefill_positions"]
                    rec["busy_ms_per_tick"] = (
                        1e3 * st["tokens_out"] / st["tokens_per_s"]
                        / max(st["decode_steps"], 1))
                eng.stop()
            torch.cuda.synchronize()
            rec["b8"] = dec_ops.decode_attention.launches
            rec["routes"] = dict(dec_ops.decode_attention.route_launches)
            rec["b8_shapes"] = [[list(k), n] for k, n in
                                sorted(shapes.items())]
            rec["slots_here"] = eng.stats()["mesh"]["slots_here"]
            rec["host_copies"] = dict(hops_mod.host_copies)
            if rank == 0 and name == "f32":
                one = TransformerLM(**LM).build(
                    "cuda", torch.Generator().manual_seed(SEED))
                ref_rows = {}
                with DecodeEngine(one, slots=SL_SLOTS, page=SL_PAGE,
                                  cache_dtype=dtype, device="cuda") as ref:
                    sl_sampled(ref, ref_rows)
                    rh = [ref.submit(p, SL_NEW) for p in prompts]
                    want = [h.result(300) for h in rh]
                rec["tokens_equal"] = all(np.array_equal(a, b)
                                          for a, b in zip(toks, want))
                rec["rows_max_abs_err"] = max(
                    float(np.abs(np.stack(rows[id(h)])
                                 - np.stack(ref_rows[id(g)])).max())
                    for h, g in zip(hs, rh))
                del one
            if rank == 0:
                rec["tokens"] = [t.tolist() for t in toks]
            del lm, eng
            torch.cuda.empty_cache()
        out[name] = rec
    return out


def serve_layouts_child(out_dir):
    """One of the four ranks of ``serve_layouts``: (R), (S) and (D) in
    turn on one group, the Engine's mesh (1,2,2)."""
    import torch.distributed as dist
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    os.environ["BIGDL_TORCH_COORDINATOR"] = f"file://{out_dir}/store"
    Engine.init(device="cuda:0", backend="gloo",
                mesh_shape=MeshLayout(1, 2, 2).shape())
    # the one-process Predictor's group of one (rank 0), built everywhere
    solo = MeshLayout(1, 1, 1).build_mesh([0])
    rec = {"rank": rank, "world": 4, "part_s": {}}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        rec[name] = fn(*args)
        rec["part_s"][name] = time.perf_counter() - t0
    with ly_float32():
        part("router_f32", sl_router, rank, solo, True)
    part("router", sl_router, rank, solo, False)
    part("server", sl_server, rank, solo)
    part("decode", sl_decode, rank)
    emit(rec)
    dist.barrier()
    Engine.reset()
    return 0


def phase_serve_layouts():
    """Serving on the mesh layouts (module docstring, 26); returns the
    kernels line's rows."""
    with tempfile.TemporaryDirectory() as tmp:
        return sl_run(tmp)


def sl_shape_sum(recs, field, pred):
    return sum(n for r in recs for k, n in r[field] if pred(k))


def sl_checks(ranks):
    """The phase's gates on every rank (module docstring, 26)."""
    L, H = LM["num_layers"], LM["num_heads"]
    members = ([0, 1], [2, 3])
    r0 = ranks[0]
    for key, route, f32 in (("router_f32", "f32", True),
                            ("router", "tc", False)):
        lead = r0[key]
        spec = SL_F32_REQUESTS if f32 else SL_REQUESTS
        check(all(n > 0 for n in lead["routed"]),
              f"serve_layouts {key}: routed {lead['routed']}")
        tol = SL_F32_TOL if f32 else LY_PREDICT_TOL
        check(lead["max_abs_err"] <= tol, f"serve_layouts {key}: answers "
              f"off the one-process Predictor by {lead['max_abs_err']} "
              f"(tolerance {tol})")
        want_answered = spec[0] + (0 if f32 else 2 * SL_SCALE + SL_LOSS)
        check(lead["answered"] == want_answered, f"serve_layouts {key}: "
              f"{lead['answered']} answers of {want_answered}")
        for i, sub in enumerate(members):
            for r in sub:
                rr = ranks[r][key]
                want = L * lead["batches"][i]
                check(rr["b6"] == want and rr["b6_lse"] == 0
                      and rr["routes"]["flash_attention"].get(route, 0)
                      == want and all(s[1] == H // 2 and s[3] == 64
                                      for s, _ in rr["b6_shapes"]),
                      f"serve_layouts {key} rank {r}: B6 {rr['b6']} "
                      f"(lse {rr['b6_lse']}) routes {rr['routes']} shapes "
                      f"{rr['b6_shapes']}, want {want} on {route!r}")
    lead = r0["router"]
    check(lead["scale_down"] == 1 and lead["live_after_down"] == 1
          and lead["scale_up"] == 2, f"serve_layouts router scale: {lead}")
    check(lead["routed_after_loss"] == [0, SL_LOSS]
          and lead["healthy_after_loss"], f"serve_layouts router loss "
          f"drill: routed {lead['routed_after_loss']}, healthy "
          f"{lead['healthy_after_loss']}")
    srv = r0["server"]
    check(srv["batch_errors"] == 0 and srv["versions"] == [1, 2]
          and srv["swapped_to"] == 2
          and srv["answered"] == 2 * SL_SERVER[0],
          f"serve_layouts server: {srv}")
    check(max(srv["max_abs_err"].values()) <= LY_PREDICT_TOL,
          f"serve_layouts server: answers off the one-process Predictor "
          f"of their version by {srv['max_abs_err']}")
    for r, rr in enumerate(ranks):
        s = rr["server"]
        want = L * srv["batches"]
        check(s["b6"] == want and s["b6_lse"] == 0
              and s["routes"]["flash_attention"].get("tc", 0) == want,
              f"serve_layouts server rank {r}: B6 {s['b6']} routes "
              f"{s['routes']}, want {want} on 'tc'")
    for name, route in (("f32", "f32"), ("bf16", "bf16")):
        d0 = r0["decode"][name]
        check(d0["graphs"]["captures"] == 0, f"serve_layouts decode "
              f"{name}: graphs {d0['graphs']}")
        for r, rr in enumerate(ranks):
            d = rr["decode"][name]
            lo, n = d["slots_here"]
            want = L * (d0["decode_steps"] + d0["prefill_positions"][lo // n])
            check(d["b8"] == want and d["routes"].get(route, 0) == want
                  and all(s[0] in (1, SL_SLOTS // 2) and s[1] == H // 2
                          for s, _ in d["b8_shapes"]),
                  f"serve_layouts decode {name} rank {r}: B8 {d['b8']} "
                  f"routes {d['routes']} shapes {d['b8_shapes']}, want "
                  f"{want} on {route!r}")
    d0 = r0["decode"]["f32"]
    check(d0["tokens_equal"] and d0["rows_max_abs_err"] <= LY_DECODE_TOL,
          f"serve_layouts decode f32: tokens equal {d0['tokens_equal']}, "
          f"rows off by {d0['rows_max_abs_err']}")
    for r, rr in enumerate(ranks):
        for key in ("router_f32", "router", "server"):
            check(not rr[key]["host_copies"], f"serve_layouts {key} rank "
                  f"{r}: tensors through hops {rr[key]['host_copies']}")
        for name in ("f32", "bf16"):
            check(not rr["decode"][name]["host_copies"], f"serve_layouts "
                  f"decode {name} rank {r}: tensors through hops")


def sl_run(tmp):
    """``phase_serve_layouts`` with ``tmp`` for the ranks' meeting."""
    t_phase = time.perf_counter()
    ranks, wall = spawn_ranks("--serve-layouts-child", tmp, SL_TIMEOUT, n=4)
    emit({"phase": "serve_layouts", "part": "ranks", "gpu": gpu_line(),
          "spawn_wall_s": wall, "part_s": [r["part_s"] for r in ranks],
          "router": {k: v for k, v in ranks[0]["router"].items()
                     if k not in ("b6_shapes", "routes")},
          "router_f32": {k: ranks[0]["router_f32"][k] for k in (
              "routed", "max_abs_err", "batches", "serve_s")},
          "server": {k: v for k, v in ranks[0]["server"].items()
                     if k not in ("b6_shapes", "routes")},
          "decode": {n: {k: v for k, v in ranks[0]["decode"][n].items()
                         if k not in ("tokens", "b8_shapes")}
                     for n in ("f32", "bf16")},
          "b6": {k: [r[k]["b6"] for r in ranks]
                 for k in ("router_f32", "router", "server")},
          "b8": {n: [r["decode"][n]["b8"] for r in ranks]
                 for n in ("f32", "bf16")}})
    sl_checks(ranks)
    H = LM["num_heads"]
    gen = torch.Generator().manual_seed(SEED + 65)
    b6 = {T: flash_case(MAX_BATCH, H // 2, T, T, 64, torch.bfloat16, True,
                        gen) for T in SEQ_BUCKETS}
    b6_f32 = flash_case(SL_F32_BATCH, H // 2, LM["max_len"], LM["max_len"],
                        64, torch.float32, True, gen)
    lens = sorted({s[-1] for r in ranks for n in ("f32", "bf16")
                   for s, _ in r["decode"][n]["b8_shapes"]})
    b8 = {(n, L): decode_case(SL_SLOTS // 2, H // 2, L, 64, dt, gen)
          for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
          for L in lens}
    cases = list(b6.values()) + [b6_f32] + list(b8.values())
    emit({"phase": "serve_layouts", "gpu": gpu_line(), "b6": b6,
          "b6_f32": b6_f32, "b8": {f"{n}_{L}": c for (n, L), c
                                   in b8.items()},
          "phase_s": time.perf_counter() - t_phase})
    for c in cases:
        check(c["ok"], f"serve_layouts kernel case {c}")
    tc = {"tc": 0, "f32": 0}
    rows = []
    for T, c in b6.items():
        n = sum(sl_shape_sum([r[k] for r in ranks], "b6_shapes",
                             lambda s, T=T: s[2] == T)
                for k in ("router", "server"))
        rows.append(kernel_row(c, "flash_attention", *B6_SRC, n,
                               f"serve_layouts router (1,1,2) and server "
                               f"(1,2,2) bf16, T = {T} (4 ranks)",
                               {**tc, "tc": n}))
    n = sum(r["router_f32"]["b6"] for r in ranks)
    rows.append(kernel_row(b6_f32, "flash_attention", *B6_SRC, n,
                           "serve_layouts router (1,1,2) float32 (4 ranks)",
                           {**tc, "f32": n}))
    for (name, L), c in b8.items():
        n = sl_shape_sum([r["decode"][name] for r in ranks], "b8_shapes",
                         lambda s, L=L: s[-1] == L)
        rows.append({**kernel_row(
            c, "decode_attention", *B8_SRC, n,
            f"serve_layouts DecodeEngine(mesh=(1,2,2)) {name}, cache "
            f"{L} (4 ranks)", {"f32": 0, "bf16": 0, name: n}),
            "floor_ms": c["floor_ms"], "splits": c["splits"]})
    return rows


# -- 27. axes_layouts ---------------------------------------------------------

AX_STEPS = 5
AX_BATCH = 16
AX_MICRO = 4
AX_TIMEOUT = 600
AX_PIPE = (2, 1, 1, 2, 1)
AX_EXPERT = (2, 1, 1, 1, 2)
AX_SEAM = (2, 1, 2)
AX_REGATHER = (1, 2, 2)
AX_PIPE_RUNS = ("gpipe", "1f1b")
#: the MoE LM's runs (one process and the ranks): (compute dtype, wire
#: dtype, tokens).  ``moe``: float32 products and gradients sent in
#: float32, on random tokens; ``moe-bf16``: the path users train, bf16
#: products and gradients sent in bf16, on ``train_moe``'s counting
#: tokens (``ax_data`` says why each)
AX_MOE_RUNS = {"moe": (torch.float32, None, "random"),
               "moe-bf16": (torch.bfloat16, torch.bfloat16, "counting")}
#: with ``CHIP_SMOKE_MOE_SPLIT=1`` also these, printed and not gated:
#: random tokens in bf16, and with each half of bf16 alone
AX_MOE_SPLIT = {"moe-bf16-random": (torch.bfloat16, torch.bfloat16,
                                    "random"),
                "moe-bf16-f32wire": (torch.bfloat16, None, "random"),
                "moe-f32-bf16wire": (torch.float32, torch.bfloat16,
                                     "random")}


def ax_split():
    return os.environ.get("CHIP_SMOKE_MOE_SPLIT") == "1"


def ax_moe_runs():
    """The MoE runs of this invocation, by name."""
    return {**AX_MOE_RUNS, **(AX_MOE_SPLIT if ax_split() else {})}


def ax_moe_policy(name):
    compute, wire, _ = ax_moe_runs()[name]
    return DTypePolicy(compute_dtype=compute, wire_dtype=wire)
#: B6 launch shape and causal flag, (B6, B6 with the log-sum-exp, B7)
#: launches a rank makes in one step, written before the first run:
#: the pipelined LM's 4 layers a pipe rank on 4 microbatches of 2 rows
#: (PS_PIPE_STEP's counts); the MoE LM's 4 layers on 8 rows; a ring of
#: 2 ranks over T = 512 on 8 rows and all 8 heads (rank 0 of the ring
#: its diagonal block, rank 1 the block below it too, PS_SEQ_STEP's
#: counts); the re-gathered (1,2,2) LM as LY_STEP's
AX_LAUNCHES = {
    "pipe-gpipe": ([[2, 8, 256, 64], True], {None: (16, 16, 32)}),
    "pipe-1f1b": ([[2, 8, 256, 64], True], {None: (32, 16, 32)}),
    "moe": ([[8, 8, 256, 64], True], {None: (4, 4, 8)}),
    "seq": (None, {0: (8, 8, 16), 1: (16, 16, 32)}),
    "seam": (None, {0: (8, 8, 16), 1: (16, 16, 32)}),
    "regather": ([[8, 4, 512, 64], True], {None: (8, 8, 16)})}
#: the Engine's collectives a rank calls in one step, by kind, written
#: before the first run (the pipe's hops come from its tables,
#: ``ax_pipe_hops``): (2,1,1,2,1) and (2,1,1,1,2) gather nothing (at
#: fsdp = tp = 1 every leaf but the stack and the tables is replicated,
#: and those keep their rows), one all-reduce of every gradient over
#: data; the MoE LM a gather of the experts' outputs and of the routing
#: counts a layer forward and a gather of the rows' gradients a layer
#: backward; data x seq one all-reduce over data and a ring's 3 hops a
#: layer; the seam under (2,1,2): the two tables and each block's
#: attention kernels gathered over tp (10) and reduce-scattered back,
#: again in the backward where a block saved them (8), 17 tp output
#: gathers and input all-reduces (2 a feed-forward, 1 the head), the
#: ring's hops, one all-reduce over data; (1,2,2) LY_COLLECTIVES' (the
#: backward's gathers of each block and the head, 9, among them)
AX_COLLECTIVES = {
    "pipe": {"all_reduce": {"grads": 1}},
    "moe": {"all_reduce": {"grads": 1},
            "all_gather": {"expert_out": 4, "expert_in": 4,
                           "moe_route": 4}},
    "seq": {"all_reduce": {"grads": 1}, "permute": {"ring": 24}},
    "seam": {"all_gather": {"params": 10, "params_bwd": 8, "tp_out": 17},
             "all_reduce": {"tp_in": 17, "grads": 1},
             "reduce_scatter": {"grads": 10}, "permute": {"ring": 24}},
    "regather": LY_COLLECTIVES[(1, 2, 2)]}


def ax_data():
    """The samples: the pipelined and dense LMs' random tokens, and the
    MoE LM's random (``"random"``) and counting (``"counting"``,
    ``train_moe``'s) tokens.  On random tokens (``CHIP_SMOKE_MOE_SPLIT=1``
    on an H100) the bf16 MoE's worst unit moved 0.0258, 0.0432, 0.0500,
    0.0527 and 0.0546 off one process's after steps 1 to 5, beyond
    ``PS_DELTA_TOL``, where the dense LMs' move 0.005 to 0.018, while the
    probe batch routed 0, 0, 0, 1, 0, 0 of rank 0's 2048 tokens otherwise
    as each step started and after the last.  bf16 products with a
    float32 wire drifted alike (0.0274 to 0.0555), float32 products with
    a bf16 wire did not (0.0030 to 0.0012), nor did float32 throughout
    (0.0022 to 0.0011, flips 0, 0, 0, 0, 1, 0): the drift starts in the
    first step's bf16 products, which run at other row counts on the
    ranks, and is no fault, so the random-token run is held to the bound
    in float32.  Tokens that count up share their gradients' direction
    (a flip moves the sum by about k / N, not sqrt(k / N)): the bf16 run,
    products and wire, is held to it on those (0.0022)."""
    n = AX_BATCH * AX_STEPS
    return {"pipe": lm_samples(n, PIPE_LM["max_len"], PIPE_LM["vocab_size"],
                               SEED + 50),
            "random": lm_samples(n, MOE["max_len"], MOE["vocab_size"],
                                 SEED + 51),
            "counting": counting_samples(n, MOE["max_len"], MOE_PERIOD,
                                         SEED + 51),
            "lm": lm_samples(n, LM["max_len"], LM["vocab_size"],
                             SEED + 52)}


def ax_first_choice(model, rows):
    """The first MoE layer's top-1 expert of each token of ``rows`` of
    ``AX_BATCH`` random-token samples (seed ``SEED + 56``), from one
    forward without grad: the router's own logits."""
    samples = lm_samples(AX_BATCH, MOE["max_len"], MOE["vocab_size"],
                         SEED + 56)[rows]
    x = torch.from_numpy(np.stack([s.feature for s in samples])).cuda()
    got, route = [], moe_mod._route

    def spy(logits, *a, **k):
        if not got:
            got.append(logits.argmax(-1).cpu())
        return route(logits, *a, **k)
    moe_mod._route = spy
    try:
        with torch.no_grad():
            model(x)
    finally:
        moe_mod._route = route
    return got[0]


@contextlib.contextmanager
def ax_uncounted(shapes=None):
    """A block whose B6 / B7 launches (and ``shapes``, a
    ``launch_counts`` Counter) and collectives count nowhere."""
    fns = (attn_ops.flash_attention, attn_ops.flash_attention_bwd)
    kept = [(fn.launches, dict(fn.route_launches)) for fn in fns]
    lse = attn_ops.flash_attention.lse_launches
    seen = dict(shapes or {})
    tallies = (Engine.all_reduces, Engine.reduce_scatters,
               Engine.all_gathers, Engine.permutes, Engine.all_to_alls)
    held = [dict(t) for t in tallies]
    try:
        yield
    finally:
        for fn, (n, routes) in zip(fns, kept):
            fn.launches, fn.route_launches = n, routes
        attn_ops.flash_attention.lse_launches = lse
        if shapes is not None:
            shapes.clear()
            shapes.update(seen)
        for t, h in zip(tallies, held):
            t.clear()
            t.update(h)


class AxProbe:
    """``train``'s per-step hook for a MoE run: as each step starts and
    after the last, the routing of ``rows`` of ``ax_first_choice``'s batch
    and, with ``units``, each unit on the host; its launches and
    collectives count nowhere (``shapes``: the run's ``launch_counts``
    Counter, once it is open)."""

    def __init__(self, model, rows, units=False):
        self.model, self.rows, self.want_units = model, rows, units
        self.choices, self.units, self.shapes = [], [], None

    def __call__(self, n):
        with ax_uncounted(self.shapes):
            self.choices.append(ax_first_choice(self.model, self.rows))
            if self.want_units:
                self.units.append([u.cpu() for u in
                                   ps_units(self.model)])

    def deltas(self):
        """Each unit's change after each step, on the host."""
        return [[u - i for u, i in zip(us, self.units[0])]
                for us in self.units[1:]]


def ax_flips(mine, one, d, b):
    """The tokens of batch rank ``d``'s ``b`` rows that ``mine`` routes
    otherwise than one process (``one``, every row) at each probe."""
    return [int((m != o.reshape(AX_BATCH, -1)[d * b:(d + 1) * b]
                 .reshape(-1)).sum()) for m, o in zip(mine, one)]


def ax_rank_major(samples, n, batch):
    """``samples`` re-ordered so that one process's shuffled batches hold
    their rows in the order the global batch of ``n`` batch ranks holds
    them, rank 0's rows first: one process's ``DataSet`` (seed ``SEED``)
    draws the ranks' permutation and rank r takes rows r, r + n, ... of
    each global batch.  The MoE routes its global batch in that order, and
    where tokens overflow an expert the order decides which are dropped."""
    perm = np.arange(len(samples))
    np.random.default_rng(SEED).shuffle(perm)
    b = batch // n
    out = list(samples)
    for k in range(len(samples) // batch):
        for q in range(batch):
            out[perm[k * batch + q]] = samples[
                perm[k * batch + n * (q % b) + q // b]]
    return out


def ax_model(kind, **kw):
    """The LM of ``kind`` from the seed, the router's jitter off (its
    draws follow the batch rank's generator)."""
    cfg = {"pipe": PIPE_LM, "moe": MOE, "lm": LM}[kind]
    model = TransformerLM(**cfg, **kw).build(
        "cuda", torch.Generator().manual_seed(SEED))
    for m in model.modules():
        if isinstance(m, moe_mod.MoEFFN):
            m.router_jitter = 0.0
    return model


def ax_train(model, samples, strategy=None, distributed=True, probe=None):
    """``AX_STEPS`` LM steps (train_lm's criterion and method) on this
    rank's rows, or one process's; (losses, host ms a step).  ``probe(n)``
    runs as step n starts and after the last, outside the steps' ms."""
    marks = []

    def on_step(n):
        t0 = time.perf_counter()
        if probe is not None:
            probe(n)
        marks.append((t0, time.perf_counter()))
    losses = train(model, samples, AX_STEPS,
                   AX_BATCH // max(Engine.group_size(), 1)
                   if distributed else AX_BATCH,
                   device=None if distributed else "cuda",
                   distributed=distributed,
                   criterion=nn.TimeDistributedCriterion(
                       nn.ClassNLLCriterion(), size_average=True),
                   method=SGD(LM_LR, momentum=0.9), on_step=on_step,
                   strategy=strategy)
    return losses, [1e3 * (b[0] - a[1]) for a, b in zip(marks, marks[1:])]


def ax_pipe_hops(sched, n, m, v, d):
    """The hops pipe rank ``d`` makes in one step (``Engine.permutes
    ["pipe"]``): the ticks of the forward table with a transfer to or
    from it, as many again in the gpipe backward (its transpose), or the
    1F1B table's."""
    fwd = build_schedule("gpipe", n, m, v)
    tf = fwd.fstash_slots
    hops = sum(1 for t in range(fwd.ticks - 1)
               if fwd.recv_f_slot[t + 1][(d + 1) % n] != tf
               or fwd.recv_f_slot[t + 1][d] != tf)
    if sched == "gpipe":
        return 2 * hops
    tbl = build_schedule("1f1b", n, m, v)
    tf, tb = tbl.fstash_slots, tbl.bstash_slots
    return hops + sum(1 for t in range(tbl.ticks - 1)
                      if tbl.recv_f_slot[t + 1][(d + 1) % n] != tf
                      or tbl.recv_b_slot[t + 1][(d - 1) % n] != tb
                      or tbl.recv_f_slot[t + 1][d] != tf
                      or tbl.recv_b_slot[t + 1][d] != tb)


def ax_kind(name):
    """The LM a run of ``axes_layouts`` trains: pipe, moe or lm."""
    return "moe" if name in ax_moe_runs() else name.split("-")[0]


def ax_one_process(data, out_dir):
    """The one-process runs on the card the ranks are held to: each
    unit's change of the unpartitioned pipelined LM, of the MoE LM in
    each of its runs (its probe's routing at each step, and with
    ``CHIP_SMOKE_MOE_SPLIT=1`` each step's change) and of the dense LM;
    their records."""
    recs = {}
    for name in ("pipe", *ax_moe_runs(), "lm"):
        kind = ax_kind(name)
        set_policy(ax_moe_policy(name) if kind == "moe" else
                   DTypePolicy(compute_dtype=torch.bfloat16))
        model = ax_model(kind)
        probe = AxProbe(model, slice(None), ax_split()) \
            if kind == "moe" else None
        init = ps_units(model)
        zero_flash()
        torch.cuda.reset_peak_memory_stats()
        samples = data[kind] if kind != "moe" else ax_rank_major(
            data[ax_moe_runs()[name][2]], AX_EXPERT[0] * AX_EXPERT[1],
            AX_BATCH)
        losses, step_ms = ax_train(model, samples, distributed=False,
                                   probe=probe)
        torch.save(ps_delta(init, ps_units(model)),
                   os.path.join(out_dir, f"ax_delta_{name}.pt"))
        if probe is not None:
            torch.save({"choices": probe.choices, "deltas": probe.deltas()},
                       os.path.join(out_dir, f"ax_steps_{name}.pt"))
        recs[name] = {"losses": losses, "host_step_ms": step_ms,
                      "max_memory_allocated":
                      torch.cuda.max_memory_allocated()}
        del model, init, probe
        train.opt = None
        torch.cuda.empty_cache()
    return recs


def ax_rank_run(kind, model, samples, strategy, ref, extra=None,
                probe=None):
    """One run of this rank: the record of the gates."""
    init = ps_units(model)
    zero_flash()
    Engine.clear_counts()
    plan = strategy.place(model) if strategy is not None else None
    if plan is not None:
        plan.reset_held()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    key = lambda q, k, v, causal, *a: (tuple(q.shape), bool(causal))
    with launch_counts(attn_ops, "_launch", key) as shapes:
        if probe is not None:
            probe.shapes = shapes
        losses, step_ms = ax_train(model, samples, strategy, probe=probe)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fwd, bwd = flash_counts()
    rec = {"losses": losses, "host_step_ms": step_ms, "run_s": run_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "start_allocated": start_allocated,
           "b6": fwd, "b6_lse": attn_ops.flash_attention.lse_launches,
           "b7": bwd, "routes": flash_routes(),
           "b6_shapes": sorted([list(s), c, n]
                               for (s, c), n in shapes.items()),
           "collectives": Engine.collectives(),
           "coord": Engine.mesh_coordinate(),
           "host_copies": dict(hops_mod.host_copies)}
    if plan is not None:
        rec.update(local_elements=plan.local_elements(),
                   whole_elements=sum(math.prod(l.whole)
                                      for l in plan.leaves),
                   held_peak=plan.held_peak,
                   gathered_bytes_max_unit=max(plan.gathered_bytes()),
                   gathered_bytes_all_units=sum(plan.gathered_bytes()))
    rec.update(extra(model) if extra else {})
    ctx = strategy.whole(model) if strategy is not None else \
        contextlib.nullcontext()
    with ctx:
        trained = ps_units(model)
    rec.update(delta_errs=ps_delta_errs(init, trained, ref),
               rank_max_abs_diff=ly_rank_diff(trained))
    del init, trained
    return rec


def ax_stack_bytes(model):
    """This rank's and the whole stage stack's bytes, and its elements."""
    stack = list(model.layers[2].stage.parameters())
    return {"stack_bytes": [memstats.tree_device_bytes(stack, "cuda"),
                            memstats.tree_total_bytes(stack)],
            "stack_whole_elements": sum(math.prod(p._layout_whole)
                                        for p in stack),
            "stage_bytes": memstats.pipeline_stage_bytes(model,
                                                         device="cuda")}


def ax_table_bytes(model):
    """This rank's and the whole expert tables' bytes, and their
    elements."""
    tables = [getattr(m, n) for m in model.modules()
              if isinstance(m, moe_mod.MoEFFN) for n in m.TABLES]
    return {"table_bytes": [memstats.tree_device_bytes(tables, "cuda"),
                            memstats.tree_total_bytes(tables)],
            "table_whole_elements": sum(math.prod(p._layout_whole)
                                        for p in tables)}


def ax_plant_expert_out():
    """A planted fault (``CHIP_SMOKE_PLANT=expert_out``), to show that
    the MoE runs' weight-change gate catches one: the ``expert_out``
    gather's backward hands every expert rank rank 0's slice of the
    gradient in place of its own.  The phase then fails."""
    gather = mesh_plan._Gather

    class Planted(gather):
        @staticmethod
        def forward(ctx, ax, x, dim, kind):
            ctx.kind = kind
            return gather.forward(ctx, ax, x, dim, kind)

        @staticmethod
        def backward(ctx, g):
            if ctx.kind != "expert_out":
                return gather.backward(ctx, g)
            c = g.shape[ctx.dim] // ctx.ax.n
            return None, g.narrow(ctx.dim, 0, c).contiguous(), None, None
    mesh_plan._Gather = Planted


def ax_moe_rank_run(name, data, out_dir):
    """This rank's MoE run ``name`` under ``AX_EXPERT``: the record of
    the gates, the probe's route flips at each step and, with
    ``CHIP_SMOKE_MOE_SPLIT=1``, each unit's |Δ - Δref| / |Δref| after
    each step."""
    set_policy(ax_moe_policy(name))
    d, b = Engine.mesh_coordinate()["data"], AX_BATCH // AX_EXPERT[0]
    model = ax_model("moe")
    probe = AxProbe(model, slice(d * b, (d + 1) * b), ax_split())
    ref = torch.load(os.path.join(out_dir, f"ax_delta_{name}.pt"))
    rec = ax_rank_run("moe", model, data[ax_moe_runs()[name][2]],
                      LayoutSharding(model), ref, ax_table_bytes, probe)
    one = torch.load(os.path.join(out_dir, f"ax_steps_{name}.pt"))
    rec["route_flips"] = ax_flips(probe.choices, one["choices"], d, b)
    rec["tokens"] = int(probe.choices[0].numel())
    if probe.units:
        rec["step_delta_errs"] = [
            [float((u - r).norm() / r.norm()) for u, r in zip(us, rs)]
            for us, rs in zip(probe.deltas(), one["deltas"])]
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    return model, rec


def axes_layouts_child(out_dir):
    """One of the four ranks of ``axes_layouts``: each run a group of
    its own (module docstring, 27)."""
    import torch.distributed as dist
    if os.environ.get("CHIP_SMOKE_PLANT") == "expert_out":
        ax_plant_expert_out()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    data = ax_data()
    refs = {k: torch.load(os.path.join(out_dir, f"ax_delta_{k}.pt"))
            for k in ("pipe", "lm")}
    runs = {}
    plan = [("pipe-" + s, AX_PIPE) for s in AX_PIPE_RUNS] + [
        (name, AX_EXPERT) for name in ax_moe_runs()] + [
        ("seq", None), ("seam", AX_SEAM), ("regather", AX_REGATHER)]
    for i, (name, lay) in enumerate(plan):
        os.environ["BIGDL_TORCH_COORDINATOR"] = f"file://{out_dir}/ax{i}"
        if name == "seam":
            os.environ["BIGDL_TORCH_RING_ATTN"] = "1"
        Engine.init(device="cuda:0", backend="gloo",
                    mesh_shape={"data": 2, "seq": 2} if lay is None else
                    MeshLayout(*lay).shape())
        hops_mod.host_copies.clear()
        if name.startswith("pipe"):
            model = partition_pipeline(ax_model("pipe"), 2,
                                       num_microbatches=AX_MICRO,
                                       schedule=name.split("-")[1])
            rec = ax_rank_run("pipe", model, data["pipe"],
                              LayoutSharding(model), refs["pipe"],
                              ax_stack_bytes)
            rec["description"] = dict(train.opt.run_description)
        elif ax_kind(name) == "moe":
            model, rec = ax_moe_rank_run(name, data, out_dir)
        elif name == "seq":
            model = ax_model("lm", seq_parallel=True)
            rec = ax_rank_run("lm", model, data["lm"], None, refs["lm"])
        else:
            model = ax_model("lm")
            rec = ax_rank_run("lm", model, data["lm"],
                              LayoutSharding(model), refs["lm"])
        os.environ.pop("BIGDL_TORCH_RING_ATTN", None)
        runs[name] = rec
        del model
        train.opt = None
        # a sharded model and its plan reference each other: free them
        # before the next run's peak is measured
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        Engine.reset()
    emit({"rank": rank, "world": 4, "runs": runs})
    return 0


def phase_axes_layouts():
    """The pipe, expert and seq axes beside the batch axes (module
    docstring, 27); returns the kernels line's rows."""
    with tempfile.TemporaryDirectory() as tmp:
        return ax_run(tmp)


def ax_launch_checks(name, run, r, what):
    moe = ax_kind(name) == "moe"
    shape, counts = AX_LAUNCHES["moe" if moe else name]
    if None in counts:
        want = counts[None]
    else:
        coord = run["coord"]
        want = counts[coord.get("seq", coord.get("tp"))]
    b6, lse, b7 = (c * AX_STEPS for c in want)
    got_shapes = {tuple(s) for s, c, n in run["b6_shapes"]}
    want_shapes = ({(8, 8, 256, 64)} if shape is None
                   else {tuple(shape[0])})
    routes = run["routes"]
    on_route = (only_route_counts(routes)
                if not moe or ax_moe_runs()[name][0] == torch.bfloat16 else
                routes["flash_attention"].get("tc", 0) == 0
                and routes["flash_attention_bwd"].get("tc", 0) == 0)
    check((run["b6"], run["b6_lse"], run["b7"]) == (b6, lse, b7)
          and got_shapes == want_shapes and on_route,
          f"{what}: launches (B6, with the log-sum-exp, B7) "
          f"{(run['b6'], run['b6_lse'], run['b7'])} != {(b6, lse, b7)} at "
          f"{run['b6_shapes']}, routes {run['routes']}")


def ax_checks(ranks):
    """The gates of every run on every rank (module docstring, 27); the
    runs of ``AX_MOE_SPLIT`` are printed, not gated."""
    for name in ranks[0]["runs"]:
        if name in AX_MOE_SPLIT:
            continue
        base = ax_kind(name)
        for r, rr in enumerate(ranks):
            run, what = rr["runs"][name], f"axes_layouts {name} rank {r}"
            steps = AX_STEPS
            check(len(run["losses"]) == steps and all(
                map(math.isfinite, run["losses"])),
                f"{what}: losses {run['losses']}")
            check(run["rank_max_abs_diff"] == 0.0, f"{what}: the weights "
                  f"differ from rank 0's by up to {run['rank_max_abs_diff']}")
            check(max(run["delta_errs"]) <= PS_DELTA_TOL, f"{what}: |Δ - Δref| / |Δref| by unit "
                  f"{run['delta_errs']} beyond {PS_DELTA_TOL}")
            ax_launch_checks(name, run, r, what)
            want = {k: {n: c * steps for n, c in v.items()}
                    for k, v in AX_COLLECTIVES[base].items()}
            if base == "pipe":
                want["permute"] = {"pipe": steps * ax_pipe_hops(
                    name.split("-")[1], 2, AX_MICRO, 1, run["coord"]["pipe"])}
            got = {k: v for k, v in run["collectives"].items() if v}
            check(got == want, f"{what}: collectives {got} != {want}")
            if base == "pipe":
                dev, total = run["stack_bytes"]
                stack = run["stack_whole_elements"]
                check(dev * 2 == total and run["local_elements"] ==
                      run["whole_elements"] - stack // 2
                      and run["stage_bytes"][0]["param_bytes_per_device"]
                      * 2 == run["stage_bytes"][0]["stacked_param_bytes"],
                      f"{what}: the stack a rank {dev} of {total} bytes, "
                      f"elements {run['local_elements']}")
                d = run["description"]
                check((d["pipe_stages"], d["pipe_microbatches"]) ==
                      (2, AX_MICRO), f"{what}: description {d}")
            if base == "moe":
                dev, total = run["table_bytes"]
                tables = run["table_whole_elements"]
                check(dev * 2 == total and run["local_elements"] ==
                      run["whole_elements"] - tables // 2,
                      f"{what}: the tables a rank {dev} of {total} bytes, "
                      f"elements {run['local_elements']}")
            if base == "regather":
                check(run["local_elements"] == LY_LOCAL[AX_REGATHER],
                      f"{what}: elements {run['local_elements']}")


def ax_run(tmp):
    """``phase_axes_layouts`` with ``tmp`` for the ranks' meeting and the
    one-process runs' weight changes."""
    t_phase = time.perf_counter()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    data = ax_data()
    one = ax_one_process(data, tmp)
    del data
    ranks, wall = spawn_ranks("--axes-layouts-child", tmp, AX_TIMEOUT, n=4)
    emit({"phase": "axes_layouts", "part": "ranks", "gpu": gpu_line(),
          "one_process": one, "ranks": ranks, "spawn_wall_s": wall})
    ax_checks(ranks)
    # the kernels at this phase's shapes
    H, D = PIPE_LM["num_heads"], PIPE_LM["d_model"] // PIPE_LM["num_heads"]
    b6p, b7p = flash_pair_cases(AX_BATCH // 2 // AX_MICRO, H,
                                PIPE_LM["max_len"], D, SEED + 53)
    T = MOE["max_len"]
    b6m = flash_case(AX_BATCH // 2, H, T, T, D, torch.float32, True,
                     torch.Generator().manual_seed(SEED + 54), with_lse=True)
    b7m = b7_case(AX_BATCH // 2, H, T, T, D, torch.float32, True,
                  torch.Generator(device="cuda").manual_seed(SEED + 54))
    b6h, b7h = flash_pair_cases(AX_BATCH // 2, H, T, D, SEED + 57)
    T = LM["max_len"] // 2
    b6r = flash_case(AX_BATCH // 2, LM["num_heads"], T, T, D,
                     torch.bfloat16, False,
                     torch.Generator().manual_seed(SEED + 55), with_lse=True)
    b7r = b7_case(AX_BATCH // 2, LM["num_heads"], T, T, D, torch.bfloat16,
                  False, torch.Generator(device="cuda").manual_seed(SEED + 55))
    for c in (b6m, b7m, b6h, b7h, b6r, b7r):
        check(c["ok"], f"axes_layouts kernel case {c}")
    runs = ranks[0]["runs"]

    def per_rank(field, names=runs):
        return {k: [r["runs"][k][field] for r in ranks] for k in names}
    rg = [r["runs"]["regather"] for r in ranks]
    regather = {
        "peak_bytes_a_rank": [x["max_memory_allocated"] for x in rg],
        "start_bytes_a_rank": [x["start_allocated"] for x in rg],
        "held_peak": [x["held_peak"] for x in rg],
        "gathered_bytes_max_unit": rg[0]["gathered_bytes_max_unit"],
        "gathered_bytes_all_units": rg[0]["gathered_bytes_all_units"]}
    moes = list(ax_moe_runs())
    emit({"phase": "axes_layouts", "gpu": gpu_line(),
          "moe_runs": {k: [str(v[0]), str(v[1]), v[2]]
                       for k, v in ax_moe_runs().items()},
          "moe_route_flips_by_step": per_rank("route_flips", moes),
          "moe_probe_tokens_a_rank": ranks[0]["runs"]["moe"]["tokens"],
          "moe_delta_errs": per_rank("delta_errs", moes),
          "moe_step_delta_errs": {k: [r["runs"][k].get("step_delta_errs")
                                      for r in ranks] for k in moes},
          "host_step_ms": per_rank("host_step_ms"),
          "run_s": per_rank("run_s"),
          "max_memory_allocated": per_rank("max_memory_allocated"),
          "regather_122": {**regather, "peak_gb_without_regather": [2.68, 2.80]},
          "host_copies": per_rank("host_copies"),
          "b6_pipe": b6p, "b7_pipe": b7p, "b6_moe": b6m, "b7_moe": b7m,
          "b6_moe_bf16": b6h, "b7_moe_bf16": b7h,
          "b6_ring": b6r, "b7_ring": b7r,
          "phase_s": time.perf_counter() - t_phase})
    tc = {"tc": 0, "f32": 0}

    def total(names, field):
        return sum(r["runs"][k][field] for r in ranks for k in names)
    pipes = ["pipe-" + s for s in AX_PIPE_RUNS]
    rings = ["seq", "seam"]
    rows = []
    for (b6, b7), names, path, route in (
            ((b6p, b7p), pipes, "axes_layouts transformer_lm_pipe "
             "(2,1,1,2,1) gpipe and 1f1b (4 ranks)", "tc"),
            ((b6m, b7m), ["moe"], "axes_layouts transformer_moe "
             "(2,1,1,1,2) float32, random tokens (4 ranks)", "f32"),
            ((b6h, b7h), ["moe-bf16"], "axes_layouts transformer_moe "
             "(2,1,1,1,2) bf16, counting tokens (4 ranks)", "tc"),
            ((b6r, b7r), rings, "axes_layouts ring blocks: data x seq and "
             "the tp seam (2,1,2), the diagonal causal (4 ranks)", "tc")):
        n6, n7 = total(names, "b6"), total(names, "b7")
        rows += [kernel_row(b6, "flash_attention", *B6_SRC, n6, path,
                            {**tc, route: n6}),
                 kernel_row(b7, "flash_attention_bwd", *B7_SRC, n7, path,
                            {**tc, route: n7})]
    return rows


# -- 28. interop --------------------------------------------------------------

IP_BATCH = 32
IP_RECORDS = 64
IP_STEPS = 3
#: a loaded ResNet-50's float32 eval forward against its source's (TF32
#: off): the same operations on the same weights; the JAX package's
#: round trip gave 0.0 on the CPU
IP_FWD_TOL = 1e-4
#: the fused bf16 fine-tune of the loaded model against the source's, from
#: the same weights and batches under deterministic cuDNN
IP_LOSS_TOL = 2e-3
#: LeNet-5 through TF and Torch7 on the card, float32 (TF32 off)
IP_CHAIN_TOL = 1e-5
IP_FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "fixtures", "interop")


def ip_sync_s(t0):
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ip_eval(model, x):
    model.eval()
    with torch.no_grad():
        return model(x).float()


def ip_fused(source):
    """A ResNet-50 fused as ``phase_train`` fuses the bench's, built on
    the card and given ``source``'s weights (``load_model_weights``: the
    leaf order is the unfused one's) and running statistics, each
    BatchNormalization's buffers copied by name from its counterpart
    (the fusion keeps the BatchNormalizations in the source's order)."""
    fused = nn.fuse_conv_bn(ResNet(50, class_num=1000, dataset="imagenet"))
    fused.build("cuda", torch.Generator().manual_seed(SEED))
    fused.load_model_weights(source)
    bns = [[m for m in model.modules()
            if isinstance(m, nn.BatchNormalization)]
           for model in (fused, source)]
    check(len(bns[0]) == len(bns[1]),
          f"interop: {len(bns[0])} BatchNormalizations fused, "
          f"{len(bns[1])} in the source")
    with torch.no_grad():
        for mine, theirs in zip(*bns):
            src = dict(theirs.named_buffers())
            dst = dict(mine.named_buffers())
            check(dst.keys() == src.keys() and all(
                dst[k].shape == src[k].shape for k in src),
                f"interop: buffers {sorted(dst)} vs {sorted(src)}")
            for k, v in src.items():
                dst[k].copy_(v)
    return fused


def ip_launches(before_counts, before_routes):
    """Launches and launches by route since the two snapshots."""
    now, routes = counts(), route_counts()
    return ({k: now[k] - before_counts[k] for k in now},
            {k: {r: routes[k][r] - before_routes[k].get(r, 0)
                 for r in routes[k]} for k in routes})


def ip_fixtures():
    """The committed fixtures on the card, each at its test's tolerance:
    {name: max abs error}."""
    out = {}
    blob = np.load(os.path.join(IP_FIX, "lenet_bn_expected.npz"))
    m, _ = interop.load_caffe(os.path.join(IP_FIX, "lenet_bn.caffemodel"))
    got = ip_eval(m, torch.from_numpy(blob["input_nhwc"]).cuda()).cpu()
    check(np.allclose(got.numpy(), blob["prob"], rtol=1e-4, atol=1e-5),
          "interop: lenet_bn.caffemodel off its expected output")
    out["lenet_bn.caffemodel"] = float(np.abs(got.numpy() - blob["prob"])
                                       .max())
    blob = np.load(os.path.join(IP_FIX, "convnet_expected.npz"))
    m, _ = interop.load_tf(os.path.join(IP_FIX, "convnet.pb"),
                           inputs=["input"], outputs="output")
    got = ip_eval(m, torch.from_numpy(blob["input"]).cuda()).cpu().numpy()
    check(np.allclose(got, blob["output"], rtol=1e-4, atol=1e-5),
          "interop: convnet.pb off its expected output")
    out["convnet.pb"] = float(np.abs(got - blob["output"]).max())
    blob = np.load(os.path.join(IP_FIX, "codec_t7_expected.npz"))
    obj = interop.load_t7(os.path.join(IP_FIX, "codec.t7"))
    check(np.array_equal(obj["weight"], blob["weight"])
          and np.array_equal(obj["bias"], blob["bias"])
          and obj["train"] is False and obj["name"] == "fixture"
          and obj["epoch"] == 3 and obj["nested"] == [10.5, "two"],
          "interop: codec.t7 decoded otherwise")
    out["codec.t7"] = 0.0
    for name, shape, gold in (("lenet_like.bigdl", (2, 28, 28, 1), (2, 10)),
                              ("simple_rnn_canonical.bigdl", (2, 5, 6),
                               (2, 5, 4))):
        path = os.path.join(IP_FIX, name)
        x = np.fromfile(path + ".x", dtype=np.float32).reshape(shape)
        want = np.fromfile(path + ".y", dtype=np.float32).reshape(gold)
        got = ip_eval(interop.load_bigdl(path),
                      torch.from_numpy(x).cuda()).cpu().numpy()
        check(np.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"interop: {name} off its golden output")
        out[name] = float(np.abs(got - want).max())
    return out


def ip_chains(tmp):
    """LeNet-5 through TF's and Torch7's savers and loaders on the card
    (those formats hold chains only): {format: max abs error}."""
    m = LeNet5(10).build("cuda", torch.Generator().manual_seed(SEED + 63))
    x = torch.randn((4, 28, 28, 1), device="cuda",
                    generator=torch.Generator(device="cuda")
                    .manual_seed(SEED + 63))
    want = ip_eval(m, x)
    out = {}
    m.save_tf(os.path.join(tmp, "lenet.pb"))
    m.save_torch(os.path.join(tmp, "lenet.t7"))
    for fmt, loaded in (
            ("tf", interop.load_tf(os.path.join(tmp, "lenet.pb"))[0]),
            ("t7", interop.load_torch_module(
                os.path.join(tmp, "lenet.t7"))[0])):
        err = float((ip_eval(loaded, x) - want).abs().max())
        check(err <= IP_CHAIN_TOL, f"interop: LeNet-5 through {fmt} {err}")
        out[fmt] = err
    return out


def ip_records(path, source):
    """``IP_RECORDS`` seeded 224 x 224 records written by the port's
    record writer.  Labels (0-based): ``source``'s top class of the image
    for every second record, its third for every fourth, a seeded class
    for the rest, so the Top-1 and Top-5 counts are far from 0 and apart."""
    rs = np.random.default_rng(SEED + 64)
    images = rs.integers(0, 256, (IP_RECORDS, 224, 224, 3)).astype(np.uint8)
    ranked = torch.cat([
        ip_eval(source, torch.from_numpy(
            images[i:i + IP_BATCH].astype(np.float32) / 255.0).cuda())
        .argsort(dim=-1, descending=True)[:, :3].cpu()
        for i in range(0, IP_RECORDS, IP_BATCH)]).numpy()
    labels = [ranked[i, 0] if i % 2 == 0 else ranked[i, 2] if i % 4 == 1
              else rs.integers(0, 1000) for i in range(IP_RECORDS)]
    write_records(path, [{"data": images[i], "label": float(labels[i])}
                         for i in range(IP_RECORDS)])


def phase_interop():
    """Model interop on the card (module docstring, 28); returns the
    kernels line's rows."""
    with tempfile.TemporaryDirectory() as tmp:
        return ip_run(tmp)


def ip_run(tmp):
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    set_policy(DTypePolicy())
    zero_counts()
    gen = torch.Generator(device="cuda")
    # (1) the source: ResNet-50 from a seed, one training forward
    source = ResNet(50, class_num=1000, dataset="imagenet").build(
        "cuda", torch.Generator().manual_seed(SEED + 60))
    x_train = torch.randn((IP_BATCH, 224, 224, 3), device="cuda",
                          generator=gen.manual_seed(SEED + 60))
    n_bn = sum(isinstance(m, nn.BatchNormalization)
               for m in source.modules())
    before = (counts(), route_counts())
    stats0 = torch.cat([b.float().flatten() for b in source.buffers()])
    source.train()
    with torch.no_grad():
        source(x_train)
    del x_train
    fwd_launched, _ = ip_launches(*before)
    moved = float((torch.cat([b.float().flatten() for b in
                              source.buffers()]) - stats0).abs().max())
    check(fwd_launched["bn_forward"] == n_bn and moved > 0,
          f"interop: the source's training forward launched "
          f"{fwd_launched}, moved its statistics by {moved}")
    x = torch.randn((IP_BATCH, 224, 224, 3), device="cuda",
                    generator=gen.manual_seed(SEED + 61))
    want = ip_eval(source, x)
    # (2) saved in the BigDL and Caffe formats, read back on the card
    times, sizes, errs = {}, {}, {}
    paths = {"bigdl": os.path.join(tmp, "resnet50.bigdl"),
             "caffe": os.path.join(tmp, "resnet50.caffemodel")}
    t0 = time.perf_counter()
    interop.save_bigdl(source, paths["bigdl"])
    times["save_bigdl_s"] = ip_sync_s(t0)
    t0 = time.perf_counter()
    interop.save_caffe(source, None, paths["caffe"])
    times["save_caffe_s"] = ip_sync_s(t0)
    loaded = {}
    for fmt in ("bigdl", "caffe"):
        sizes[fmt] = os.path.getsize(paths[fmt])
        t0 = time.perf_counter()
        loaded[fmt] = (interop.load_bigdl(paths[fmt]) if fmt == "bigdl"
                       else interop.load_caffe(paths[fmt])[0])
        times[f"load_{fmt}_s"] = ip_sync_s(t0)
        check(next(loaded[fmt].parameters()).is_cuda,
              f"interop: the {fmt} model is not on the card")
        errs[fmt] = float((ip_eval(loaded[fmt], x) - want).abs().max())
        check(errs[fmt] <= IP_FWD_TOL, f"interop: ResNet-50 from {fmt} "
              f"{errs[fmt]} off the source")
    del loaded["caffe"]
    # (3) model_validator over records against the source's Evaluator
    data = os.path.join(tmp, "val")
    ip_records(data, source)
    res = Evaluator(source).test(
        DataSet.array(zoo_run._load_samples(data, None)),
        [Top1Accuracy(), Top5Accuracy()], batch_size=IP_BATCH)
    source_counts = {m.name: list(r.result()) for m, r in res}
    check(source_counts["Top1Accuracy"][0] >= 0.5
          and source_counts["Top5Accuracy"][0] >= 0.75,
          f"interop: the records' labels missed the source {source_counts}")
    validated = {}
    for fmt in ("bigdl", "caffe"):
        t0 = time.perf_counter()
        got = model_validator.validate(fmt, paths[fmt], data,
                                       batch_size=IP_BATCH)
        times[f"validate_{fmt}_s"] = ip_sync_s(t0)
        validated[fmt] = {k: [v["accuracy"], v["count"]]
                          for k, v in got.items()}
        check(validated[fmt] == source_counts, f"interop: model_validator "
              f"{fmt} {validated[fmt]} != the source's {source_counts}")
    # (4) the fused bf16 fine-tune: the model loaded from the BigDL file
    # beside the source, each fused, the same batches, deterministic
    # cuDNN; before it, each fused model's float32 eval forward against
    # the source's (the fusion's eval forward is the unfused one)
    tuned = ip_fused(loaded.pop("bigdl"))
    twin = ip_fused(source)
    for name, model in (("loaded", tuned), ("source", twin)):
        errs[f"fused_{name}"] = float((ip_eval(model, x) - want).abs().max())
        check(errs[f"fused_{name}"] <= IP_FWD_TOL, f"interop: the fused "
              f"{name} model {errs[f'fused_{name}']} off the source")
    del source, x, want
    torch.cuda.empty_cache()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    samples = synthetic_imagenet(IP_BATCH * IP_STEPS, SEED + 62)
    runs = {}
    seen, handles = record_shapes(tuned)
    with deterministic_cudnn():
        for name, model in (("loaded", tuned), ("source", twin)):
            before = (counts(), route_counts())
            on_step, step_ms = ps_step_ms(IP_STEPS)
            losses = train(model, samples, IP_STEPS, IP_BATCH,
                           on_step=on_step)
            torch.cuda.synchronize()
            launched, routes = ip_launches(*before)
            if handles:
                for h in handles:
                    h.remove()
                handles = []
            runs[name] = {"losses": losses, "host_step_ms": step_ms(),
                          "launches": launched, "routes": routes}
            check(len(losses) == IP_STEPS and all(map(math.isfinite,
                                                      losses)),
                  f"interop: {name} losses {losses}")
            check(launched == {k: v * IP_STEPS
                               for k, v in STEP_LAUNCHES.items()},
                  f"interop: {name} launches over {IP_STEPS} steps "
                  f"{launched}")
            for kind, rt in STEP_ROUTES.items():
                want_r = dict.fromkeys(routes[kind], 0)
                want_r[rt] = launched[kind]
                check(routes[kind] == want_r,
                      f"interop: {name} {kind} by route {routes[kind]}")
    loss_diff = max(abs(a - b) for a, b in zip(runs["loaded"]["losses"],
                                               runs["source"]["losses"]))
    check(loss_diff <= IP_LOSS_TOL and runs["loaded"]["launches"] ==
          runs["source"]["launches"], f"interop: the fine-tunes' losses "
          f"{runs['loaded']['losses']} vs {runs['source']['losses']}")
    # (5) the tuned model saved in the BigDL format and reloaded
    resaved = os.path.join(tmp, "tuned.bigdl")
    t0 = time.perf_counter()
    interop.save_bigdl(tuned, resaved)
    times["save_tuned_bigdl_s"] = ip_sync_s(t0)
    raw = open(resaved, "rb").read()
    back = interop.load_bigdl(resaved)
    mine, theirs = tuned.get_weights_bias(), back.get_weights_bias()
    leaves_equal = (
        len(mine) == len(theirs)
        and all(np.array_equal(a, b) for a, b in zip(mine, theirs))
        and len(list(tuned.buffers())) == len(list(back.buffers()))
        and all(torch.equal(a, b) for a, b in zip(tuned.buffers(),
                                                  back.buffers())))
    del mine, theirs
    fused_left = [c for c in (b"ConvBN", b"Fused") if c in raw]
    check(leaves_equal and not fused_left, f"interop: the tuned model "
          f"reloads bit-equal {leaves_equal}, fused classes {fused_left}")
    del tuned, twin, back
    torch.cuda.empty_cache()
    # the path's launches: the source's forward and both fine-tunes (the
    # cases below launch the kernels again, and count nothing here)
    launched, routes = counts(), route_counts()
    # (6) the fixtures and the chain-only formats
    set_policy(DTypePolicy())
    fixtures = ip_fixtures()
    chains = ip_chains(tmp)
    # the kernels at the fine-tune's largest call of each
    cases = {}
    kgen = torch.Generator(device="cuda").manual_seed(SEED + 65)
    for kind in ("bn_forward", "bn_backward", "bn_grad_stats",
                 "matmul_stats"):
        shape = max(seen[kind], key=lambda sh: (
            sh[0] * sh[1] + sh[1] * sh[2] + sh[0] * sh[2]
            if len(sh) == 3 else sh[0] * sh[1]))
        cases[kind] = bn_case(kind, shape, torch.bfloat16, kgen,
                              seen[kind][shape] // IP_STEPS)
        check(cases[kind]["ok"], f"interop: {kind} at {shape} "
              f"{cases[kind]}")
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = tf32
    emit({"phase": "interop", "gpu": gpu_line(), "file_bytes": sizes,
          "host_s": times, "forward_max_abs_err": errs,
          "source_counts": source_counts, "validated": validated,
          "source_forward_launches": fwd_launched, "fine_tune": runs,
          "loss_max_abs_diff": loss_diff, "resaved_bit_equal":
          leaves_equal, "fixtures_max_abs_err": fixtures,
          "chains_max_abs_err": chains, "cases": cases,
          "path_launches": launched, "path_routes": routes,
          "phase_s": time.perf_counter() - t_phase})
    path = ("interop ResNet-50 from a BigDL file and its source: the "
            "source's float32 training forward, then a fused bf16 "
            f"fine-tune of each at batch {IP_BATCH}")
    rows = kernel_rows({k: (c, None) for k, c in cases.items()},
                       launched, path, routes)
    for row in rows:
        row["shape"] = cases[row["name"]]["shape"]
    return rows


# -- 29. mixed_layouts --------------------------------------------------------

#: where the phase's models live: the card (a CPU rehearsal of the
#: phase's logic sets "cpu" and stubs the card's counters)
MX_DEVICE = "cuda"
#: the bf16 LMs' embeddings need their 5 steps: at 3 M1's moved 0.0227
#: off one process, past ``PS_DELTA_TOL`` (PERF.md, run X1)
MX_STEPS = 5
MX_BATCH = 16
MX_MICRO = 4
MX_TIMEOUT = 600
MX_PIPE_TP = (1, 1, 2, 2, 1)
MX_EXPERT_TP = (1, 1, 2, 1, 2)
MX_PIPE_EXPERT = (1, 1, 1, 2, 2)
MX_REMAT = (1, 2, 2)
MX_REMAT_STEPS = 3
MX_BUCKETS = (2, 1, 1, 2, 1)
MX_BUCKET_MB = 4
MX_LBFGS = (2, 2, 1)
MX_LBFGS_BATCH = 128       # the README's quick start
MX_LBFGS_LR = 0.1
#: LeNet-5's and Wide & Deep's float32 weights (TF32 off), and Wide &
#: Deep's eval forward, against one process's on the card
MX_F32_TOL = 1e-4
MX_TABLES = (1, 1, 2, 1, 2)
MX_TABLE_STEPS = 3
#: the (1,2,2) rank's bf16 peak with the re-gather in ``axes_layouts``
#: (PERF.md, run F25r)
MX_PEAK_AXES_GB = 2.624
#: the runs, in order: (model, layout, compute dtype, tokens, options).
#: ``hybrid`` is ``transformer_moe``'s width with its first block a MoE
#: block and two dense blocks after it, the pipeline's 2 stages: the
#: reference refuses a stage that holds a MoEFFN (its state), so a
#: 2-stage ``transformer_moe`` does not exist there (ROADMAP.md queue C)
MX_RUNS = {
    "m1-gpipe": ("pipe", MX_PIPE_TP, torch.bfloat16, "pipe",
                 {"schedule": "gpipe"}),
    "m1-1f1b": ("pipe", MX_PIPE_TP, torch.bfloat16, "pipe",
                {"schedule": "1f1b"}),
    "m1-f32": ("pipe", MX_PIPE_TP, torch.float32, "pipe",
               {"schedule": "gpipe"}),
    "m2-f32": ("moe", MX_EXPERT_TP, torch.float32, "random", {}),
    "m2-bf16": ("moe", MX_EXPERT_TP, torch.bfloat16, "counting", {}),
    "m3": ("hybrid", MX_PIPE_EXPERT, torch.float32, "random",
           {"schedule": "gpipe"}),
    "m4": ("lm", MX_REMAT, torch.float32, "lm", {}),
    "m4-remat": ("lm", MX_REMAT, torch.float32, "lm", {"remat": "full"}),
    "m5": ("pipe", MX_BUCKETS, torch.float32, "pipe",
           {"schedule": "gpipe", "env": {"BIGDL_TORCH_FUSED_UPDATE": "1"}}),
    "m5-buckets": ("pipe", MX_BUCKETS, torch.float32, "pipe",
                   {"schedule": "gpipe",
                    "env": {"BIGDL_TORCH_FUSED_UPDATE": "1",
                            "BIGDL_TORCH_WIRE_BUCKET_MB":
                            str(MX_BUCKET_MB)}}),
    "m6": ("lenet", MX_LBFGS, torch.float32, "mnist", {}),
    "m7": ("widedeep", MX_TABLES, torch.float32, "criteo", {}),
}
#: the runs whose weights must be bit-equal to an earlier run's: remat
#: and the wire's buckets change no number
MX_SAME = {"m4-remat": "m4", "m5-buckets": "m5"}
#: B6 launch shapes and (B6, B6 with the log-sum-exp, B7) a rank makes in
#: one step, written before the first run: the pipelined LM's 4 layers a
#: pipe rank on 4 microbatches of its 16 rows, every head (a stage is not
#: split over tp), 1f1b's forward without the log-sum-exp and its
#: recompute with it; the MoE LM's 4 layers on 16 rows and 4 of the 8
#: heads; the hybrid's MoE block on 16 rows and its pipe rank's dense
#: block on 4 microbatches; the (1,2,2) LM's 8 layers on 8 rows and 4
#: heads, twice forward under remat; (2,1,1,2,1)'s pipe rank on 4
#: microbatches of its 8 rows; LeNet-5 and Wide & Deep none
MX_LAUNCHES = {
    "m1-gpipe": ({(4, 8, 256, 64): 16}, (16, 16, 32)),
    "m1-1f1b": ({(4, 8, 256, 64): 32}, (32, 16, 32)),
    "m1-f32": ({(4, 8, 256, 64): 16}, (16, 16, 32)),
    "m2-f32": ({(16, 4, 256, 64): 4}, (4, 4, 8)),
    "m2-bf16": ({(16, 4, 256, 64): 4}, (4, 4, 8)),
    "m3": ({(16, 8, 256, 64): 1, (4, 8, 256, 64): 4}, (5, 5, 10)),
    "m4": ({(8, 4, 512, 64): 8}, (8, 8, 16)),
    "m4-remat": ({(8, 4, 512, 64): 16}, (16, 16, 16)),
    "m5": ({(2, 8, 256, 64): 16}, (16, 16, 32)),
    "m5-buckets": ({(2, 8, 256, 64): 16}, (16, 16, 32)),
    "m6": ({}, (0, 0, 0)),
    "m7": ({}, (0, 0, 0)),
}
#: the Engine's collectives a rank calls in one step, by kind, written
#: before the first run from the same structures at small widths on 4
#: gloo CPU ranks, every leaf split as at full width (m4's are
#: ``LY_COLLECTIVES``' (1,2,2) ones): the pipe's hops come from its
#: tables (``ax_pipe_hops``) and m5-buckets' all-reduces from the plan
#: (one a bucket of ``MX_BUCKET_MB``, ``mx_rank_run``).  Under (1,1,2,2,1)
#: the tables and the head are split over tp (2 gathers and scatters),
#: the stack over pipe alone; under (1,1,2,1,2) the tables, the gates,
#: the attention and the head on tp, the expert tables kept; (1,1,1,2,2)
#: gathers nothing but the experts' outputs and rows; remat recomputes
#: 10 of the 11 units (the positional table saves nothing); LBFGS's 22
#: dot products (2 a history slot of 10, and 2) over the fsdp shards
MX_COLLECTIVES = {
    "m1": {"all_reduce": {"tp_in": 1}, "reduce_scatter": {"grads": 2},
           "all_gather": {"params": 2, "tp_out": 1}},
    "m2": {"all_reduce": {"tp_in": 9}, "reduce_scatter": {"grads": 6},
           "all_gather": {"params": 6, "tp_out": 9, "expert_out": 4,
                          "expert_in": 4, "params_bwd": 4, "tp_bias": 4}},
    "m3": {"all_gather": {"expert_out": 1, "expert_in": 1}},
    "m4": LY_COLLECTIVES[(1, 2, 2)],
    "m4-remat": {"all_reduce": {"tp_in": 33, "grads": 1},
                 "reduce_scatter": {"grads": 11},
                 "all_gather": {"params": 21, "tp_out": 66, "tp_bias": 8}},
    "m5": {"all_reduce": {"grads": 1}},
    "m6": {"all_reduce": {"grads": 2, "dot": 22},
           "reduce_scatter": {"grads": 1},
           "all_gather": {"params": 1, "params_bwd": 1}},
    "m7": {"all_reduce": {"tp_in": 2}, "reduce_scatter": {"grads": 1},
           "all_gather": {"params": 1, "tp_out": 2}}}


def mx_collectives(name, run):
    """The collectives a step of run ``name`` stated in advance."""
    if name == "m5-buckets":
        return {"all_reduce": {"grads": run["plan_buckets"]}}
    return MX_COLLECTIVES.get(name, MX_COLLECTIVES.get(name.split("-")[0]))


def mx_ref(name):
    """The file of the one-process run that run ``name`` is held to: one
    a model, tokens and dtype."""
    kind, _, dtype, tokens, _ = MX_RUNS[name]
    return f"mx_{kind}_{tokens}_{str(dtype).split('.')[-1]}.pt"


def mx_config(kind):
    return {"pipe": PIPE_LM, "moe": MOE, "hybrid": MOE, "lm": LM}[kind]


def mx_policy(name):
    kind, _, dtype, _, _ = MX_RUNS[name]
    wire = torch.bfloat16 if dtype == torch.bfloat16 and kind in (
        "moe", "hybrid") else None
    return DTypePolicy(compute_dtype=dtype, wire_dtype=wire) \
        if kind not in ("lenet", "widedeep") else DTypePolicy()


def mx_model(name, device=None):
    """The model of run ``name`` from the seed (unpartitioned), the
    router's jitter off."""
    kind = MX_RUNS[name][0]
    device = device or MX_DEVICE
    gen = torch.Generator().manual_seed(SEED)
    if kind == "lenet":
        return LeNet5(10).build(device, gen)
    if kind == "widedeep":
        from bigdl_torch.dataset import FeatureSpec
        from bigdl_torch.models import WideDeep
        return WideDeep.from_spec(FeatureSpec(), embed_dim=WD_EMBED,
                                  hidden=WD_HIDDEN).build(device, gen)
    cfg = mx_config(kind)
    if kind == "hybrid":
        from bigdl_torch.models.transformer_lm import (PositionalEmbedding,
                                                       TransformerBlock)
        d, h = cfg["d_model"], cfg["num_heads"]
        model = nn.Sequential(
            nn.LookupTable(cfg["vocab_size"], d),
            PositionalEmbedding(cfg["max_len"], d),
            TransformerBlock(d, h, num_experts=cfg["num_experts"]),
            TransformerBlock(d, h), TransformerBlock(d, h),
            nn.LayerNorm(d), nn.Linear(d, cfg["vocab_size"]),
            nn.LogSoftMax())
        model.build(device, gen)
    else:
        model = TransformerLM(**cfg).build(device, gen)
    for m in model.modules():
        if isinstance(m, moe_mod.MoEFFN):
            m.router_jitter = 0.0
    return model


def mx_data():
    """The samples of every run, made anew from the seed."""
    from bigdl_torch.dataset import (FeatureSpec, TabularToSample,
                                     synthetic_criteo_records)
    n = MX_BATCH * MX_STEPS
    spec = FeatureSpec()
    criteo = list(TabularToSample(spec)(synthetic_criteo_records(
        WD_BATCH * (MX_TABLE_STEPS + 1), spec=spec, seed=SEED + 74)))
    return {"pipe": lm_samples(n, PIPE_LM["max_len"],
                               PIPE_LM["vocab_size"], SEED + 70),
            "random": lm_samples(n, MOE["max_len"], MOE["vocab_size"],
                                 SEED + 71),
            "counting": counting_samples(n, MOE["max_len"], MOE_PERIOD,
                                         SEED + 71),
            "lm": lm_samples(MX_BATCH * MX_REMAT_STEPS, LM["max_len"],
                             LM["vocab_size"], SEED + 72),
            "mnist": synthetic_mnist(MX_LBFGS_BATCH * MX_STEPS, SEED + 73),
            "criteo": criteo[:WD_BATCH * MX_TABLE_STEPS],
            "criteo_eval": criteo[WD_BATCH * MX_TABLE_STEPS:]}


def mx_sync(reset=False, empty=False):
    """On the card: wait for it (``reset``: then start the peak over,
    ``empty``: give the cache back); the peak allocated bytes."""
    if MX_DEVICE == "cpu":
        return 0
    torch.cuda.synchronize()
    if reset:
        torch.cuda.reset_peak_memory_stats()
    if empty:
        torch.cuda.empty_cache()
    return torch.cuda.max_memory_allocated()


def mx_optimizer(name, model, samples, strategy=None, distributed=False):
    """The Optimizer of run ``name`` over ``samples`` (the ranks' rows
    where ``distributed``): the LM criterion and SGD 0.01 with momentum,
    LeNet-5's ``LBFGS``, Wide & Deep's SGD; its steps and the list its
    losses land in."""
    kind = MX_RUNS[name][0]
    steps = {"lm": MX_REMAT_STEPS, "widedeep": MX_TABLE_STEPS}.get(
        kind, MX_STEPS)
    batch = {"lenet": MX_LBFGS_BATCH, "widedeep": WD_BATCH}.get(
        kind, MX_BATCH)
    if distributed:
        batch //= max(Engine.group_size(), 1)
    crit = (nn.ClassNLLCriterion() if kind in ("lenet", "widedeep") else
            nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                        size_average=True))
    method = {"lenet": lambda: LBFGS(MX_LBFGS_LR),
              "widedeep": lambda: SGD(WD_LR)}.get(
        kind, lambda: SGD(LM_LR, momentum=0.9))()
    losses = {}

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > steps
    opt = Optimizer(model, DataSet.array(samples, distributed=distributed,
                                         seed=SEED), crit,
                    batch_size=batch,
                    device=None if distributed else MX_DEVICE,
                    strategy=strategy)
    opt.set_optim_method(method)
    opt.set_end_when(Trigger(end, "steps"))
    if MX_RUNS[name][4].get("remat"):
        opt.set_remat(MX_RUNS[name][4]["remat"])
    return opt, losses


def mx_forward(model, samples):
    """The eval forward of ``samples`` (float32, no grad), on the host."""
    x = torch.from_numpy(np.stack([s.feature for s in samples])).to(
        MX_DEVICE)
    model.eval()
    with torch.no_grad():
        return model(x).float().cpu()


def mx_one_process(data, out_dir):
    """The one-process runs on the card the ranks are held to, one a
    model and dtype: each unit's change (LeNet-5's and Wide & Deep's
    trained weights, and Wide & Deep's eval forward); their records."""
    recs = {}
    firsts = {}
    for name in MX_RUNS:
        firsts.setdefault(mx_ref(name), name)
    for ref_file, name in firsts.items():
        kind, _, _, tokens, _ = MX_RUNS[name]
        set_policy(mx_policy(name))
        model = mx_model(name)
        init = ps_units(model)
        opt, losses = mx_optimizer(name, model, data[tokens])
        t0 = time.perf_counter()
        opt.optimize()
        mx_sync()
        rec = {"losses": [losses[k] for k in sorted(losses)],
               "run_s": time.perf_counter() - t0}
        trained = ps_units(model)
        # written whole before the ranks, which start beside this, see it
        path = os.path.join(out_dir, ref_file)
        torch.save({"trained": [u.cpu() for u in trained],
                    "delta": ps_delta(init, trained),
                    "forward": mx_forward(model, data["criteo_eval"])
                    if kind == "widedeep" else None}, path + ".part")
        os.replace(path + ".part", path)
        recs[name] = rec
        del model, opt, init, trained
        mx_sync(empty=True)
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    return recs


def mx_wait(path):
    """``path`` once the one-process run, which runs beside the ranks,
    has written it."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        check(time.perf_counter() - t0 < MX_TIMEOUT,
              f"mixed_layouts: no one-process run at {path}")
        time.sleep(0.05)
    return path


def mx_rank_run(name, data, out_dir):
    """This rank's run ``name``: the record of the gates."""
    t_setup = time.perf_counter()
    kind, lay, _, tokens, opts = MX_RUNS[name]
    set_policy(mx_policy(name))
    model = mx_model(name)
    init = ps_units(model)
    if opts.get("schedule"):
        model = partition_pipeline(model, 2, num_microbatches=MX_MICRO,
                                   schedule=opts["schedule"])
    strategy = LayoutSharding(model)
    plan = strategy.place(model)
    plan.reset_held()
    zero_flash()
    Engine.clear_counts()
    mx_sync(reset=True)
    key = lambda q, k, v, causal, *a: tuple(q.shape)
    with knobs(opts.get("env", {})):
        opt, losses = mx_optimizer(name, model, data[tokens], strategy,
                                   distributed=True)
        t0 = time.perf_counter()
        with launch_counts(attn_ops, "_launch", key) as shapes:
            opt.optimize()
        mx_sync()
        run_s = time.perf_counter() - t0
    t_after = time.perf_counter()
    fwd, bwd = flash_counts()
    rec = {"losses": [losses[k] for k in sorted(losses)], "run_s": run_s,
           "setup_s": t0 - t_setup, "steps": len(losses),
           "max_memory_allocated": mx_sync(),
           "b6": fwd, "b6_lse": attn_ops.flash_attention.lse_launches,
           "b7": bwd, "routes": flash_routes(),
           "b6_shapes": sorted([list(s), n] for s, n in shapes.items()),
           "collectives": Engine.collectives(),
           "coord": Engine.mesh_coordinate(),
           "local_elements": plan.local_elements(),
           "plan_elements": sum(math.prod(plan.cut(
               l, torch.empty(l.whole, device="meta")).shape)
               for l in plan.leaves),
           "held_peak": plan.held_peak,
           "tp_modules": sorted({type(m).__name__
                                 for m in plan.tp_modules()}),
           "expert_modules": sum("_ep" in m.__dict__
                                 for m in model.modules()),
           # one all-reduce a bucket of the leaves' gradients over data
           "plan_buckets": len(bucket_assignment(
               [l.param.numel() for l in plan.leaves], 4, MX_BUCKET_MB))}
    if kind == "pipe" or kind == "hybrid":
        rec["stage_bytes"] = memstats.pipeline_stage_bytes(
            model, device=MX_DEVICE)
    if kind == "widedeep":
        rec["tables"] = memstats.embedding_table_bytes(model,
                                                       device=MX_DEVICE)
        with torch.no_grad():
            rec["forward"] = mx_forward(model, data["criteo_eval"])
    ref = torch.load(mx_wait(os.path.join(out_dir, mx_ref(name))))
    with strategy.whole(model):
        trained = ps_units(model)
    rec.update(delta_errs=ps_delta_errs(init, trained, ref["delta"]),
               max_abs_from_one=max(float((t - r.to(t.device)).abs().max())
                                    for t, r in zip(trained,
                                                    ref["trained"])),
               rank_max_abs_diff=ly_rank_diff(trained))
    if kind == "widedeep":
        rec["forward_max_abs_from_one"] = float(
            (rec.pop("forward") - ref["forward"]).abs().max())
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    trained = [t.cpu() for t in trained]
    rec["after_s"] = time.perf_counter() - t_after
    return model, rec, trained


def mixed_layouts_child(out_dir):
    """One of the four ranks of ``mixed_layouts``: each run a group of
    its own (module docstring, 29)."""
    import torch.distributed as dist
    t_child = time.perf_counter()
    if os.environ.get("CHIP_SMOKE_PLANT") == "expert_group":
        mx_plant_expert_group()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    data = mx_data()
    data_s = time.perf_counter() - t_child
    runs, kept = {}, {}
    for i, name in enumerate(MX_RUNS):
        os.environ["BIGDL_TORCH_COORDINATOR"] = f"file://{out_dir}/mx{i}"
        t_init = time.perf_counter()
        Engine.init(device=MX_DEVICE if MX_DEVICE == "cpu" else "cuda:0",
                    backend="gloo",
                    mesh_shape=MeshLayout(*MX_RUNS[name][1]).shape())
        init_s = time.perf_counter() - t_init
        model, runs[name], trained = mx_rank_run(name, data, out_dir)
        runs[name]["init_s"] = init_s
        base = MX_SAME.get(name)
        if base is not None:
            # set_remat and the wire's buckets change nothing
            runs[name]["max_abs_from_" + base] = max(
                float((a - b).abs().max()) for a, b in zip(trained,
                                                           kept.pop(base)))
        elif name in MX_SAME.values():
            kept[name] = trained
        del model, trained
        gc.collect()
        mx_sync(empty=True)
        dist.barrier()
        Engine.reset()
    emit({"rank": rank, "world": 4, "runs": runs, "data_s": data_s,
          "child_s": time.perf_counter() - t_child})
    return 0


def mx_plant_expert_group():
    """A planted fault (``CHIP_SMOKE_PLANT=expert_group``), to show that
    the gates of expert x tp and pipe x expert catch one: a ``MoEFFN`` on
    its expert rows slices and gathers over the group of the layout's
    other wide axis (tp under (1,1,2,1,2), pipe under (1,1,1,2,2)) in
    place of its expert group.  Each rank still runs its own experts, but
    the gather hands back its own experts' outputs from both ranks of that
    group, so half the experts' outputs are another half's.  The phase
    then fails."""
    rows = moe_mod.MoEFFN.mesh_rows

    def planted(self, plan):
        out = rows(self, plan)
        ep = self.__dict__.get("_ep")
        if ep is not None:
            other = next(a for a in ("tp", "pipe")
                         if plan.sizes.get(a, 1) > 1)
            self._ep = mesh_plan.TpAxis(Engine.axis_group((other,)), ep.n,
                                        ep.rank)
        return out
    moe_mod.MoEFFN.mesh_rows = planted


def phase_mixed_layouts():
    """The whole 5-axis layout (module docstring, 29); returns the
    kernels line's rows."""
    with tempfile.TemporaryDirectory() as tmp:
        return mx_run(tmp)


def mx_checks(ranks):
    """The gates of every run on every rank (module docstring, 29)."""
    for name, (kind, lay, dtype, _, opts) in MX_RUNS.items():
        shapes, want = MX_LAUNCHES[name]
        for r, rr in enumerate(ranks):
            run, what = rr["runs"][name], f"mixed_layouts {name} rank {r}"
            check(len(run["losses"]) == run["steps"] and all(
                map(math.isfinite, run["losses"])),
                f"{what}: losses {run['losses']}")
            check(run["rank_max_abs_diff"] == 0.0, f"{what}: the gathered "
                  f"weights differ from rank 0's by up to "
                  f"{run['rank_max_abs_diff']}")
            if kind in ("lenet", "widedeep"):
                check(run["max_abs_from_one"] <= MX_F32_TOL,
                      f"{what}: weights {run['max_abs_from_one']} off one "
                      f"process's")
            else:
                check(max(run["delta_errs"]) <= PS_DELTA_TOL,
                      f"{what}: |Δ - Δref| / |Δref| by unit "
                      f"{run['delta_errs']} beyond {PS_DELTA_TOL}")
            check(run["local_elements"] == run["plan_elements"],
                  f"{what}: elements {run['local_elements']} != the plan's "
                  f"{run['plan_elements']}")
            n = run["steps"]
            b6, lse, b7 = (c * n for c in want)
            got_shapes = {tuple(s): c for s, c in run["b6_shapes"]}
            route = "tc" if dtype == torch.bfloat16 else "f32"
            routes = run["routes"]
            on_route = all(v == 0 for fn in ("flash_attention",
                                             "flash_attention_bwd")
                           for k, v in routes[fn].items() if k != route)
            check((run["b6"], run["b6_lse"], run["b7"]) == (b6, lse, b7)
                  and got_shapes == {s: c * n for s, c in shapes.items()}
                  and on_route,
                  f"{what}: launches (B6, with the log-sum-exp, B7) "
                  f"{(run['b6'], run['b6_lse'], run['b7'])} != "
                  f"{(b6, lse, b7)} at {run['b6_shapes']}, routes {routes}")
            want_c = {k: {c: m * n for c, m in v.items()}
                      for k, v in mx_collectives(name, run).items()}
            if opts.get("schedule"):
                hops = ax_pipe_hops(opts["schedule"], 2, MX_MICRO, 1,
                                    run["coord"]["pipe"])
                want_c["permute"] = {"pipe": n * hops}
            got_c = {k: v for k, v in run["collectives"].items() if v}
            check(got_c == want_c, f"{what}: collectives {got_c} != "
                  f"{want_c}")
            if kind in ("pipe", "hybrid"):
                (sb,) = run["stage_bytes"]
                check(sb["param_bytes_per_device"] * 2 ==
                      sb["stacked_param_bytes"],
                      f"{what}: the stage stack {sb}")
            if lay[2] > 1 and kind == "pipe":
                check(run["tp_modules"] == ["Linear"], f"{what}: tp "
                      f"modules {run['tp_modules']} (only the head)")
            if kind in ("moe", "hybrid"):
                check(run["expert_modules"] == (
                    MOE["num_layers"] if kind == "moe" else 1),
                    f"{what}: {run['expert_modules']} layers on their "
                    "experts")
            if kind == "widedeep":
                check(len(run["tables"]) == 2 and all(
                    t["device_fraction"] == 0.25 for t in run["tables"]),
                    f"{what}: tables {run['tables']}")
                check(run["forward_max_abs_from_one"] <= MX_F32_TOL,
                      f"{what}: forward {run['forward_max_abs_from_one']} "
                      "off one process's")
            base = MX_SAME.get(name)
            if base is not None:
                diff = run["max_abs_from_" + base]
                check(diff == 0.0, f"{what}: weights {diff} off {base}'s")


def mx_run(tmp):
    """``phase_mixed_layouts`` with ``tmp`` for the ranks' meeting and the
    one-process runs."""
    t_phase = time.perf_counter()
    one, one_s = {}, []

    def one_process():
        # beside the ranks' start: each waits for its run's file
        t_one = time.perf_counter()
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            one.update(mx_one_process(mx_data(), tmp))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        one_s.append(time.perf_counter() - t_one)
    ranks, wall = spawn_ranks("--mixed-layouts-child", tmp, MX_TIMEOUT, n=4,
                              meanwhile=one_process)
    one_s, = one_s
    emit({"phase": "mixed_layouts", "part": "ranks", "gpu": gpu_line(),
          "one_process": one, "one_process_s": one_s, "ranks": ranks,
          "spawn_wall_s": wall})
    mx_checks(ranks)
    # the kernels at this phase's new shapes
    H, D = MOE["num_heads"], MOE["d_model"] // MOE["num_heads"]
    T = MOE["max_len"]
    b6p, b7p = flash_pair_cases(MX_BATCH // MX_MICRO, H, T, D, SEED + 75)
    cases = {}
    # float32: M2's rows and half the heads, a pipe rank's microbatch
    # (M1's twin, M3), (1,2,2)'s rows and heads (M4), a microbatch of a
    # data rank's rows (M5)
    for key, (B, h, t) in {
            "moe_f32": (MX_BATCH, H // 2, T),
            "stage_f32": (MX_BATCH // MX_MICRO, H, T),
            "lm_f32": (MX_BATCH // 2, LM["num_heads"] // 2, LM["max_len"]),
            "data_stage_f32": (MX_BATCH // 2 // MX_MICRO, H, T)}.items():
        cases[key] = (
            flash_case(B, h, t, t, D, torch.float32, True,
                       torch.Generator().manual_seed(SEED + 76),
                       with_lse=True),
            b7_case(B, h, t, t, D, torch.float32, True,
                    torch.Generator(device="cuda").manual_seed(SEED + 76)))
    cases["moe_bf16"] = flash_pair_cases(MX_BATCH, H // 2, T, D, SEED + 77)
    for c in (b6p, b7p, *[x for p in cases.values() for x in p]):
        check(c["ok"], f"mixed_layouts kernel case {c}")
    runs = ranks[0]["runs"]

    def per_rank(field):
        return {k: [r["runs"][k][field] for r in ranks] for k in runs}
    peak = {k: [r["runs"][k]["max_memory_allocated"] / 1e9 for r in ranks]
            for k in ("m4", "m4-remat")}
    emit({"phase": "mixed_layouts", "gpu": gpu_line(),
          "runs": {k: {"model": v[0], "layout": list(v[1]),
                       "dtype": str(v[2]), "tokens": v[3],
                       "options": {o: w for o, w in v[4].items()}}
                   for k, v in MX_RUNS.items()},
          "run_s": per_rank("run_s"), "setup_s": per_rank("setup_s"),
          "after_s": per_rank("after_s"), "init_s": per_rank("init_s"),
          "child_s": [r["child_s"] for r in ranks],
          "data_s": [r["data_s"] for r in ranks],
          "losses": per_rank("losses"),
          "delta_errs": per_rank("delta_errs"),
          "max_abs_from_one": per_rank("max_abs_from_one"),
          "collectives": per_rank("collectives"),
          "all_reduces_a_step": {k: [r["runs"][k]["collectives"][
              "all_reduce"].get("grads", 0) / r["runs"][k]["steps"]
              for r in ranks] for k in ("m5", "m5-buckets")},
          "peak_gb_a_rank": peak, "peak_gb_axes_layouts": MX_PEAK_AXES_GB,
          "held_peak": per_rank("held_peak"),
          "tables": [r["runs"]["m7"]["tables"] for r in ranks],
          "table_forward_max_abs_from_one": [
              r["runs"]["m7"]["forward_max_abs_from_one"] for r in ranks],
          "b6_pipe": b6p, "b7_pipe": b7p,
          **{f"{w}_{k}": c for k, p in cases.items()
             for w, c in zip(("b6", "b7"), p)},
          "phase_s": time.perf_counter() - t_phase})
    tc = {"tc": 0, "f32": 0}

    def total(names, field):
        return sum(r["runs"][k][field] for r in ranks for k in names)
    rows = []
    for (b6, b7), names, path, route in (
            ((b6p, b7p), ["m1-gpipe", "m1-1f1b"], "mixed_layouts "
             "transformer_lm_pipe (1,1,2,2,1) gpipe and 1f1b (4 ranks)",
             "tc"),
            (cases["moe_f32"], ["m2-f32"], "mixed_layouts transformer_moe "
             "(1,1,2,1,2) float32, random tokens (4 ranks)", "f32"),
            (cases["moe_bf16"], ["m2-bf16"], "mixed_layouts transformer_moe "
             "(1,1,2,1,2) bf16, counting tokens (4 ranks)", "tc"),
            (cases["stage_f32"], ["m1-f32", "m3"], "mixed_layouts "
             "transformer_lm_pipe (1,1,2,2,1) gpipe float32, and a MoE "
             "block and 2 dense stages (1,1,1,2,2) float32, the stages' "
             "microbatches (4 ranks)", "f32"),
            (cases["lm_f32"], ["m4", "m4-remat"], "mixed_layouts "
             "transformer_lm (1,2,2) float32 without and with remat "
             "(4 ranks)", "f32"),
            (cases["data_stage_f32"], ["m5", "m5-buckets"], "mixed_layouts "
             "transformer_lm_pipe (2,1,1,2,1) float32 fused, without and "
             "with buckets (4 ranks)", "f32")):
        n6, n7 = total(names, "b6"), total(names, "b7")
        rows += [kernel_row(b6, "flash_attention", *B6_SRC, n6, path,
                            {**tc, route: n6}),
                 kernel_row(b7, "flash_attention_bwd", *B7_SRC, n7, path,
                            {**tc, route: n7})]
    return rows


def timed(name, fn, *args):
    """``fn(*args)``, then a line with the phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase": name, "phase_s": time.perf_counter() - t0})
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-child"]:
        return dp_child(sys.argv[2])
    if sys.argv[1:2] == ["--zero-child"]:
        return zero_child(sys.argv[2])
    if sys.argv[1:2] == ["--cudnn-probe"]:
        return cudnn_probe_child(sys.argv[2])
    if sys.argv[1:2] == ["--elastic-child"]:
        return ef_child(sys.argv[2])
    if sys.argv[1:2] == ["--pipe-seq-child"]:
        return pipe_seq_child(sys.argv[2])
    if sys.argv[1:2] == ["--layouts-child"]:
        return layouts_child(sys.argv[2])
    if sys.argv[1:2] == ["--serve-layouts-child"]:
        return serve_layouts_child(sys.argv[2])
    if sys.argv[1:2] == ["--axes-layouts-child"]:
        return axes_layouts_child(sys.argv[2])
    if sys.argv[1:2] == ["--mixed-layouts-child"]:
        return mixed_layouts_child(sys.argv[2])
    if sys.argv[1:3] == ["--only", "mixed_layouts"]:
        timed("build", phase_build)
        timed("mixed_layouts", phase_mixed_layouts)
        return 0
    if sys.argv[1:3] == ["--only", "interop"]:
        timed("build", phase_build)
        timed("interop", phase_interop)
        return 0
    if sys.argv[1:3] == ["--only", "axes_layouts"]:
        timed("build", phase_build)
        timed("axes_layouts", phase_axes_layouts)
        return 0
    if sys.argv[1:3] == ["--only", "serve_layouts"]:
        timed("build", phase_build)
        timed("serve_layouts", phase_serve_layouts)
        return 0
    if sys.argv[1:3] == ["--only", "layouts"]:
        timed("build", phase_build)
        timed("layouts", phase_layouts)
        return 0
    if sys.argv[1:3] == ["--only", "pipe_seq"]:
        timed("build", phase_build)
        timed("pipe_seq", phase_pipe_seq)
        return 0
    if sys.argv[1:3] == ["--only", "elastic_fleet"]:
        timed("build", phase_build)
        timed("elastic_fleet", phase_elastic_fleet)
        return 0
    if sys.argv[1:3] == ["--only", "observe"]:
        timed("build", phase_build)
        timed("observe", phase_observe)
        return 0
    if sys.argv[1:3] == ["--only", "train_moe"]:
        timed("build", phase_build)
        timed("train_moe", phase_train_moe)
        return 0
    if sys.argv[1:3] == ["--only", "train_validate"]:
        timed("build", phase_build)
        timed("train_validate", phase_train_validate, None)
        return 0
    if sys.argv[1:3] == ["--only", "train_longrun"]:
        timed("build", phase_build)
        timed("train_longrun", phase_train_longrun)
        return 0
    if sys.argv[1:3] == ["--only", "train_records"]:
        timed("build", phase_build)
        timed("train_records", phase_train_records)
        return 0
    if sys.argv[1:3] == ["--only", "train_ptb"]:
        timed("build", phase_build)
        timed("train_ptb", phase_train_ptb)
        return 0
    if sys.argv[1:3] == ["--only", "layers"]:
        timed("build", phase_build)
        timed("layers", phase_layers)
        return 0
    if sys.argv[1:3] == ["--only", "train_zoo"]:
        timed("build", phase_build)
        timed("train_zoo", phase_train_zoo)
        return 0
    if sys.argv[1:3] == ["--only", "zoo_data"]:
        timed("build", phase_build)
        timed("zoo_data", phase_zoo_data)
        return 0
    if sys.argv[1:3] == ["--only", "serve_stack"]:
        timed("build", phase_build)
        timed("serve_stack", phase_serve_stack)
        return 0
    if sys.argv[1:3] == ["--only", "data_parallel"]:
        timed("build", phase_build)
        timed("dp_train", phase_dp_train, None)
        timed("dp_two_process", phase_dp_two_process)
        timed("zero_full_width", phase_zero_full_width)
        return 0
    t_script = time.perf_counter()
    timed("build", phase_build)
    rep = timed("kernels", phase_kernels)
    model, launches, routes = timed("serve", phase_serve)
    timed("generate", phase_generate, model)
    decode_row = timed("decode", phase_decode, model)
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
    train_rows, first_loss, step_ms = timed("train", phase_train)
    rows += train_rows
    rows += timed("dp_train", phase_dp_train, first_loss)
    timed("dp_two_process", phase_dp_two_process)
    timed("zero_full_width", phase_zero_full_width)
    lm_rows = timed("train_lm", phase_train_lm)
    rows += lm_rows
    timed("train_validate", phase_train_validate, step_ms)
    rows += timed("train_longrun", phase_train_longrun, lm_rows)
    rows += timed("train_records", phase_train_records, train_rows)
    timed("train_ptb", phase_train_ptb)
    timed("layers", phase_layers)
    rows += timed("train_zoo", phase_train_zoo)
    rows += timed("zoo_data", phase_zoo_data, {
        "inception_v1": phase_train_zoo.rates["inception_v1"],
        "resnet50": {"phase": "train", "images_per_s":
                     TRAIN_BATCH / (step_ms / 1e3),
                     "config": "fused, bf16, batch 256"}})
    rows += timed("serve_stack", phase_serve_stack)
    rows += timed("elastic_fleet", phase_elastic_fleet)
    rows += timed("observe", phase_observe)
    rows += timed("train_moe", phase_train_moe)
    rows += timed("pipe_seq", phase_pipe_seq)
    rows += timed("layouts", phase_layouts)
    rows += timed("serve_layouts", phase_serve_layouts)
    rows += timed("axes_layouts", phase_axes_layouts)
    rows += timed("interop", phase_interop)
    rows += timed("mixed_layouts", phase_mixed_layouts)
    rows.append(decode_row)
    emit({"script_s": time.perf_counter() - t_script})
    emit({"kernels": rows})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
