"""Training and bulk inference: ``Optimizer``, ``Predictor``.

Counterpart of ``bigdl_tpu/optim/optimizer.py`` for what the serving and
training slices use.  The reference compiles a whole train step (forward,
loss, backward, wire cast, update) into one SPMD program over a mesh;
PyTorch runs eagerly, so here one step is the training forward, the loss,
``loss.backward()``, every gradient rounded through
``DTypePolicy.wire_dtype`` (``parallel/wire.py``), and the method's
in-place update.  The driver loop and its state are the reference's
(``:1678-1866``): ``epoch`` and ``neval`` 1-based, ``evalCounter`` 0-based
in lockstep with ``neval``, the schedule's lr read each iteration, end
triggers checked before every batch, a non-finite loss raised as
:class:`NonFiniteLossError`.

Data parallel: after ``Engine.init()`` (or with ``strategy=DataParallel()``)
every rank runs this loop on its own rows.  The strategy broadcasts the
parameters and buffers from rank 0 at the start, and after each backward
averages the gradients (and the loss the driver observes) over the group
in one all-reduce, before the wire cast and the update.  BatchNorm
statistics are synced inside the forward and backward (``nn/fused.py``,
``nn/normalization.py``).  ``BIGDL_TORCH_WIRE_BUCKET_MB`` > 0 cuts that
all-reduce into buckets launched from the backward, and
``ShardedDataParallel`` (ZeRO) reduce-scatters the gradients, updates each
rank's 1/N slices and all-gathers them back (``parallel/sharding.py``):
the strategy's ``own`` views are what the regularizers, scales, wire,
clipping and the update see.  ``BIGDL_TORCH_FUSED_UPDATE=1`` runs the
update over one flat tensor per dtype (``optim/fused.py``), bit-identical
to the per-leaf update.  Both knobs are read when ``optimize`` starts;
one bucket cap drives the all-reduce's buckets and the wire cast's.

Input pipeline (the reference's ``_open_data_pipeline``, ``:647-688``):
at ``BIGDL_TORCH_PREFETCH_DEPTH`` > 0 (default 2) one worker thread
(``dataset/prefetch.py``) runs the dataset's transformer chain ahead of the
loop and, with ``BIGDL_TORCH_PREFETCH_STAGE`` (default on), stages each
batch on the device (:class:`_Stager`): on CUDA it copies the host batch
into a pinned buffer of a ring and issues the host-to-device copy on a
side stream, and the step's stream waits on that copy's event.  At depth 0
the loop assembles and copies each batch itself (:func:`_put_batch`), the
synchronous path.  Both give the step the same bytes in the same order.
The pipe is closed at every epoch's end and on every exception.  The
counters ``"get batch time average"`` and ``"computing time average"``
(``Optimizer.metrics``) hold the loop's wait for each batch and the rest of
each iteration.

Dropout draws its masks from the Optimizer's own ``torch.Generator`` on the
training device, seeded when ``optimize`` starts and handed to the training
forward (``nn/dropout.py`` ``dropout_rng``), the counterpart of the
reference's ``next_rng_key()`` per step.  The seed is ``BIGDL_TORCH_SEED``
with the Engine's rank folded in (:func:`dropout_seed`): the reference
draws one mask over the global batch, so each rank's rows need masks of
their own, not copies of rank 0's.

A step follows the reference's order (``:826-852``): the gradients, their
average over the group (under a strategy), the layers' regularizer terms
(``optim/regularizer.py``), the wire cast, constant clipping
(``set_constant_gradient_clipping``), L2-norm clipping
(``set_gradient_clipping_by_l2_norm``: the norm over every gradient in
float32, each scaled by ``min(1, c / (norm + 1e-12))``), then the update.

Validation (``set_validation``) scores the model on a held-out DataSet
after every iteration and epoch boundary where its trigger fires, before
the checkpoint decision, in eval mode under ``torch.inference_mode()`` (so
BatchNorm's running statistics and the Dropout generator are untouched),
then back in training mode.  It writes ``score``, ``val_loss``, each
method's own name and ``val_obs`` into the driver state, for triggers and
schedules.  Under a group each rank scores its own rows and the results'
fields are summed in one all-reduce.

Checkpoints (``set_checkpoint``) are the reference's files
(``utils/file_io.py``): ``model.<n>`` holds ``{"params", "state"}`` as
reference trees, ``optimMethod.<n>`` the method's ``state_dict()``, its
state as a reference tree (``utils/convert.py``), ``"rng_state": None``,
the driver state, and the Dropout generator's state under
``"torch_rng_state"`` (a key the reference's loader ignores).  Only rank 0
writes; ``keep_last`` / ``keep_every_epochs`` prune the lineage.
``resume_from(model_path, optim_path)`` reads and checks both blobs before
it changes anything, quarantines a corrupt snapshot and falls back to the
newest valid older one; ``optimize()`` then starts from the resumed driver
and method state.  Snapshots of either package load in the other.

``Evaluator``, ``Validator`` and ``Predictor`` over a DataSet or a list of
Samples batch with ``SampleToMiniBatch(pad_last=True)`` and score only each
batch's valid rows; the forward of batch i+1 is queued before batch i's
output is copied to the host (through :class:`HostCopy`).  Under the
Engine's group ``Evaluator`` and ``Predictor`` spread each batch over the
ranks (the reference's ``_ShardedForward``): padded to a multiple of the
world, each rank forwards its own block; ``Predictor`` all-gathers the
rows back into order and ``Evaluator`` sums every rank's results, so every
rank gets the same answer.

The long-run half of the step (``:137-177``, ``:801-860``):
``set_gradient_accumulation(k)`` splits each batch along axis 0 into k
contiguous microbatches, each run forward and backward in order
(BatchNorm's running statistics advance once per microbatch, each draws
its own Dropout masks); the gradients are summed, then divided by k, and
the loss is the microbatches' mean.  ``set_remat`` runs each segment of
each microbatch's forward (the children of nested ``Sequential`` s,
:func:`_segments`) under ``torch.utils.checkpoint`` (``utils/remat.py``).  The
layer-wise scales (``Module.scale_w`` / ``scale_b``) multiply the
gradients after the regularizer, so a scale of 0 freezes a layer, weight
decay included.

The fault-tolerant run (``:1044-1188``, ``:1276-1307``): ``optimize()``
retries a failed attempt, a :class:`NonFiniteLossError` or a supervisor's
``StallError`` included, up to ``BIGDL_TORCH_RETRY_TIMES`` within each
``BIGDL_TORCH_RETRY_INTERVAL`` window, resuming from the checkpoint
lineage; before the first snapshot it restores the host copy of the
starting parameters, buffers, method state and Dropout generator it took
at the start (a failed update leaves the in-place tensors half-updated).
``KeyboardInterrupt``, :class:`ConfigurationError` and
:class:`TrainingPreempted` are re-raised, and so is every failure without
a checkpoint path.  A CUDA error that poisons the context fails every
retry the same way: the budget runs out and the original error is raised.
With a checkpoint path, SIGTERM sets a flag; at the next iteration
boundary (under a group, one small all-reduce of the flag, so every rank
stops at the same one) the driver writes a snapshot, drains asynchronous
writes and raises :class:`TrainingPreempted`.  ``set_supervision`` arms
``utils/supervisor.py``'s watchdog over the loop's phases and the input
worker; chaos points (``utils/chaos.py``): ``data.stall``, ``data.batch``
(in the worker when prefetching), ``step.stall``, ``step.loss_nan``.

``set_checkpoint(async_write=True)`` copies the snapshot to pinned host
memory on a side stream, ordered after the iteration's update by the
stream's wait; the next step's stream waits on that copy's event before it
changes a parameter or buffer, and only the pickle, the CRC and the write
run on ``file_io``'s writer thread.  A write error surfaces at the next
boundary or at the end of the run.  Paths with a scheme go through
``file_io``'s registered or fsspec filesystems.  ``set_train_summary``
writes Loss, LearningRate and Throughput every logged iteration and, under its
``"Parameters"`` trigger, a histogram of every parameter (copied to the
host only then); ``set_validation_summary`` every validation result.

The loss reaches the host as in the reference (``:1773-1783``): on an
iteration that ``set_log_interval(n)`` logs (default every one) the step's
own loss is read; on the others the previous step's is read after this
step is queued, so they never wait on the card, and an epoch's last pending
loss is read at its end.  Triggers see that ``state["loss"]``; the train
summary's scalars and ``"computing time average"`` come from logged
iterations.  ``set_drop_module_property`` is the reference's straggler
drop (``:491-566``): an iteration whose host data wait exceeds the k-th
largest wait of the last window, the prefetch queue being empty, is
skipped before its step (``metrics["dropped iterations"]``).

Under ZeRO a checkpoint all-gathers the method state's slices on every
rank before rank 0 writes the reference's whole tree, and a resumed state
is cut back to each rank's slices, so snapshots move between ZeRO and
``DataParallel`` runs of either package.

``set_checkpoint(publish=True)`` makes every ``publish_every``-th
snapshot a release (``serve/continuous.ReleasePublisher``) that a
``DeployController`` canaries into a live server; an asynchronous write
publishes once its bytes are on storage.

Not ported yet: the elastic recovery (ROADMAP queue A item 6),
``TensorParallel`` and ``LayoutSharding`` (item 8).
"""

from __future__ import annotations

import copy
import itertools
import logging
import math
import os
import re
import signal
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..common import get_policy, resolve_device
from ..dataset import AbstractDataSet, DataSet, Sample, SampleToMiniBatch
from ..dataset.transformer import Batcher
from ..dataset.prefetch import PrefetchIterator, prefetch_depth
from ..nn.criterion import Criterion
from ..nn.dropout import dropout_rng
from ..nn.module import Module
from ..parallel.sharding import DataParallel, ShardingStrategy
from ..parallel.wire import wire_bucket_mb, wire_cast
from ..utils import chaos, config, file_io, remat
from ..utils import supervisor as supervision
from ..utils.convert import (check_reference_tree, load_reference_opt_state,
                             load_reference_tree, to_reference_opt_state,
                             to_reference_tree)
from ..utils.engine import Engine
from ..utils.util import kth_largest
from .method import SGD, OptimMethod
from .metrics import Metrics
from .regularizer import apply_regularizer_grads
from .trigger import Trigger
from .validation import ValidationMethod

logger = logging.getLogger("bigdl_torch")

__all__ = ["Optimizer", "DistriOptimizer", "LocalOptimizer", "Predictor",
           "Evaluator", "Validator",
           "DistriValidator", "LocalValidator", "NonFiniteLossError",
           "ConfigurationError", "TrainingPreempted", "HostCopy", "to_host"]


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array.  numpy has no bfloat16, so a
    bfloat16 tensor widens to float32 first; that widening is exact."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class HostCopy:
    """Answers to the host through one pinned buffer: ``copy(t)`` gives
    what :func:`to_host` gives, bit for bit.  A CUDA tensor (a bfloat16
    one widened to float32 on the device, exactly) is copied on a side
    stream into a pinned buffer that is kept and reused while the answer
    fits, the host waits on an event, and the answer is copied out into
    memory of its own, which the caller may keep.  Threads take turns.  A
    CPU tensor goes through :func:`to_host`.

    By default the copy waits for all the work queued on the current
    stream.  ``copy(t, ready=event)`` waits only for ``event``, recorded
    after ``t`` was made, so work queued since (the next batch's forward)
    runs beside the copy; ``t`` must then need no conversion (contiguous,
    not bfloat16): :func:`_eval_output` makes it so."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buf: Optional[torch.Tensor] = None
        self._stream = None
        self._done = None

    def __call__(self, t: torch.Tensor, ready=None) -> np.ndarray:
        if t.device.type != "cuda":
            return to_host(t)
        t = t.detach()
        if ready is not None and (t.dtype == torch.bfloat16
                                  or not t.is_contiguous()):
            raise ValueError("HostCopy(ready=...) copies a contiguous, "
                             "non-bfloat16 tensor as it is")
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.contiguous()
        n = t.numel()
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(t.device)
                self._done = torch.cuda.Event()
            if self._buf is None or self._buf.numel() < n or \
                    self._buf.dtype != t.dtype:
                self._buf = None    # the old buffer goes first
                self._buf = torch.empty(n, dtype=t.dtype, pin_memory=True)
            stage = self._buf[:n].view(t.shape)
            if ready is None:
                self._stream.wait_stream(torch.cuda.current_stream(t.device))
            else:
                self._stream.wait_event(ready)
            with torch.cuda.stream(self._stream):
                stage.copy_(t, non_blocking=True)
                self._done.record()
            self._done.synchronize()
            out = torch.empty(t.shape, dtype=t.dtype)
            out.copy_(stage)
        return out.numpy()


class NonFiniteLossError(RuntimeError):
    """The host-observed training loss went NaN or Inf: the retry loop
    resumes from the newest valid snapshot."""


class ConfigurationError(ValueError):
    """A setup error no retry can fix (a batch the accumulation steps do
    not divide, an epoch with no batch): the retry loop re-raises it."""


class TrainingPreempted(RuntimeError):
    """Raised after SIGTERM's final snapshot: the process is being
    evicted, and its next incarnation resumes from the lineage."""


def opt_state_nbytes(state) -> int:
    """The bytes of every tensor in a method state (scalars such as
    Adam's int32 ``t`` are not tensors and count nothing)."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(opt_state_nbytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(opt_state_nbytes(v) for v in state)
    return 0


def _as_dataset(dataset):
    """A plain sequence of Samples becomes a DataSet; other inputs pass
    through (the reference's ``_as_dataset``)."""
    if isinstance(dataset, (list, tuple)) and dataset and \
            isinstance(dataset[0], Sample):
        return DataSet.array(list(dataset))
    return dataset


def _find_batchers(dataset):
    """Every :class:`Batcher` in a dataset's transformer chain."""
    batchers = []

    def walk(obj):
        if obj is None:
            return
        if isinstance(obj, Batcher):
            batchers.append(obj)
        for attr in ("first", "second", "transformer", "base"):
            walk(getattr(obj, attr, None))
    walk(dataset)
    return batchers


def _segments(model):
    """The checkpointed segments of a remat step: the children of a
    top-level ``Sequential``, a child that is itself a ``Sequential``
    opened in turn (ResNet-50's stem layers and bottlenecks, the LM's
    embeddings, attention and MLP halves and head); a model of another
    kind is one segment.  One checkpoint over the whole forward would
    rebuild every activation at once at the start of the backward, which
    is the peak without remat; a segment rebuilds only its own."""
    from ..nn.containers import Sequential
    if type(model).forward is not Sequential.forward or \
            len(model.layers) < 2:
        return [model]
    return [seg for child in model.layers for seg in _segments(child)]


def _param_paths(model):
    """(name, parameter) in the reference's tree order, each name its
    path in the param tree (``"3/1/weight"``), as the reference names
    its histograms."""
    from ..nn.module import Container

    def walk(m, path):
        if isinstance(m, Container):
            for i, c in m.tree_children():
                yield from walk(c, path + [str(i)])
        else:
            for n in sorted(m.param_names):
                yield "/".join(path + [n]), getattr(m, n)
    return list(walk(model, []))


def _put_batch(x, device):
    """A host array as a tensor on ``device``, copied synchronously from
    pageable memory (the reference's ``_put_batch``, ``:263-274``)."""
    return torch.as_tensor(np.asarray(x)).to(device)


def dropout_seed(rank: int) -> int:
    """The seed of a rank's Dropout generator: ``BIGDL_TORCH_SEED`` on rank
    0 (and without a group), distinct on every other rank.  It stays in 32
    bits, all that the CPU generator (a Mersenne twister) keeps; an odd
    multiplier maps distinct ranks to distinct seeds."""
    return (config.seed() + rank * 0x9E3779B1) & 0xFFFFFFFF


class _Stager:
    """Stages host batches on the device from the input worker (the
    reference's staging ``produce``, ``optimizer.py:672-682``).

    On the CPU a batch becomes tensors with ``torch.as_tensor``: pinned
    memory needs CUDA.  On CUDA each array is copied into a pinned buffer
    (``copy_`` over a ``torch.from_numpy`` view, which releases the GIL, so
    the main thread keeps launching kernels meanwhile), and the
    host-to-device copy is issued with ``non_blocking=True`` on a side
    stream, followed by an event the consumer's stream waits on
    (:func:`_consume`).  The buffers form a ring of ``slots``; a slot is
    rewritten only after its previous copy's event has completed.  The
    Optimizer keeps one stager across epochs and retries, so its pinned
    memory does not grow with either (:meth:`pinned_bytes`)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self._slots = [{"bufs": [None, None], "event": None}
                       for _ in range(slots)]
        self._next = 0
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def pinned_bytes(self) -> int:
        """The bytes of pinned memory the ring holds."""
        return sum(b.numel() * b.element_size() for slot in self._slots
                   for b in slot["bufs"] if b is not None)

    def _pinned(self, slot, i, a: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(a))
        buf = slot["bufs"][i]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = slot["bufs"][i] = torch.empty(src.shape, dtype=src.dtype,
                                                pin_memory=True)
        buf.copy_(src)
        return buf

    def __call__(self, batch):
        """``(input, target, event)`` on the device; ``event`` is None on
        the CPU."""
        arrays = (batch.get_input(), batch.get_target())
        if self._stream is None:
            return (*(None if a is None else _put_batch(a, self.device)
                      for a in arrays), None)
        # the worker thread's current device is its own, not the caller's
        torch.cuda.set_device(self.device)
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot["event"] is not None:
            slot["event"].synchronize()  # its last copy has left the buffers
        with torch.cuda.stream(self._stream):
            out = [None if a is None else
                   self._pinned(slot, i, np.asarray(a)).to(
                       self.device, non_blocking=True)
                   for i, a in enumerate(arrays)]
            event = torch.cuda.Event()
            event.record(self._stream)
        slot["event"] = event
        return out[0], out[1], event


def _consume(staged):
    """Make the current stream wait for a staged batch's copy; returns
    (input, target)."""
    inp, tgt, event = staged
    if event is not None:
        stream = torch.cuda.current_stream(inp.device)
        stream.wait_event(event)
        # the tensors were allocated on the side stream: tell the caching
        # allocator they are used on this one, or it may hand their memory
        # to the next batch while this step still reads them
        for t in (inp, tgt):
            if t is not None:
                t.record_stream(stream)
    return inp, tgt


def _prefetched_input(data_iter):
    """An evaluation input iterator through the input worker
    (``dataset/prefetch.py``), the reference's ``_prefetched_input``:
    (iterator, pipe or None); at depth 0 the iterator as it is.  The caller
    closes the pipe."""
    depth = prefetch_depth()
    if depth <= 0:
        return iter(data_iter), None
    pipe = PrefetchIterator(data_iter, depth=depth,
                            name="bigdl-torch-eval-prefetch")
    return pipe, pipe


def _eval_output(out, valid: int):
    """A forward's output cut to its ``valid`` rows and made ready to copy
    to the host as it is (float32 for a bfloat16 output, contiguous), with
    an event recorded after it on CUDA (None on the CPU): (tensor, event).
    Nested outputs stay nested."""
    def cut(t):
        t = t.detach()[:valid]
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.contiguous()
    out = ([cut(t) for t in out] if isinstance(out, (list, tuple))
           else cut(out))
    first = out[0] if isinstance(out, list) else out
    event = None
    if first.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(first.device))
    return out, event


def _fetch(to_host, out, event):
    if isinstance(out, list):
        return [to_host(t, ready=event) for t in out]
    return to_host(out, ready=event)


def _forward_batches(engine, batches, to_host):
    """(host output of the batch's valid rows that the engine computed,
    batch, the first of those rows, their count) for each batch, in order;
    a sharded rank whose share holds no valid row keeps one padding row
    (count 0), so that it can score a result that adds nothing.  Batch i+1's
    forward is queued before batch i's output is copied to the host, so the
    card computes while the host copies and scores (the reference's
    one-deep output pipeline, ``Evaluator.test``)."""
    pending = None
    it, pipe = _prefetched_input(batches)
    try:
        for batch in it:
            out, n = engine(batch.get_input())
            lo, count = engine.rows(batch.valid, n)
            keep = max(count, 1) if engine.shards > 1 else count
            ready = _eval_output(out, keep)
            if pending is not None:
                yield _fetch(to_host, *pending[0]), *pending[1:]
            pending = (ready, batch, lo, count)
    finally:
        if pipe is not None:
            pipe.close()
    if pending is not None:
        yield _fetch(to_host, *pending[0]), *pending[1:]


def _score(engine, dataset, methods, to_host):
    """Every validation method summed over the dataset's batches, each
    batch cut to its valid rows (under a sharded engine, to this rank's
    share of them, a share without one scoring a zeroed result): one
    result per method (None where no batch gave a row)."""
    totals = [None] * len(methods)
    for out, batch, lo, count in _forward_batches(
            engine, dataset.data(train=False), to_host):
        n = len(out[0] if isinstance(out, list) else out)
        if n == 0:
            continue
        tgt = _block(np.asarray(batch.get_target()), lo, n)
        for i, m in enumerate(methods):
            r = m(out, tgt)
            if count == 0:
                r = _zeroed(r)
            totals[i] = r if totals[i] is None else totals[i] + r
    return totals


def _zeroed(result):
    """A result of ``result``'s kind that adds nothing: every numeric field
    0."""
    z = copy.copy(result)
    for k, v in vars(z).items():
        if isinstance(v, (int, float)):
            setattr(z, k, type(v)(0))
    return z


def _reduce_results(totals, device):
    """Sum every result's numeric fields over the Engine's group in one
    all-reduce (the reference's ``_reduce_results``, ``:1990-2005``).
    Every result class is a flat struct of numbers with ``+`` semantics."""
    fields = [(tot, k, v) for tot in totals for k, v in vars(tot).items()
              if isinstance(v, (int, float))]
    vec = torch.tensor([float(v) for _, _, v in fields],
                       dtype=torch.float64, device=device)
    Engine.all_reduce(vec, "validation")
    for (tot, k, orig), v in zip(fields, vec.tolist()):
        setattr(tot, k, int(v) if isinstance(orig, int) else float(v))
    return totals


class _PeekedDataSet(AbstractDataSet):
    """Replays a peeked-into iterator on the first ``data()`` call, then
    hands out the wrapped dataset's (the reference's ``_PeekedDataSet``):
    the Evaluator's batch-size peek loses nothing from a one-shot
    source."""

    def __init__(self, inner, first, rest):
        self._inner = inner
        self._replay = (first, rest)

    def size(self):
        return self._inner.size()

    def shuffle(self):
        self._inner.shuffle()

    def data(self, train=False):
        if self._replay is not None:
            first, rest = self._replay
            self._replay = None
            return itertools.chain([first], rest)
        return self._inner.data(train=train)


def _batched(dataset, batch_size):
    """``dataset`` (a DataSet or a list of Samples) batched for evaluation:
    Samples into MiniBatches of ``batch_size`` with the last one padded
    (``pad_last``); a dataset of MiniBatches as it is when ``batch_size``
    is None.  A dataset of Samples with no batch size takes 128, the
    reference's default."""
    dataset = _as_dataset(dataset)
    if batch_size is None:
        it = iter(dataset.data(train=False))
        first = next(it, None)
        if first is not None:
            dataset = _PeekedDataSet(dataset, first, it)
            if not hasattr(first, "get_input"):
                batch_size = 128
    if batch_size is not None:
        dataset = dataset.transform(SampleToMiniBatch(batch_size,
                                                      pad_last=True))
    return dataset


class Optimizer:
    """Trains ``model`` on ``dataset`` against ``criterion`` (reference:
    optim/Optimizer.scala:42 and the loop of DistriOptimizer.scala) on one
    device: the CUDA device, or ``device="cpu"``; with neither it raises.
    An unbuilt model is built there; a built one must already live there.

        Optimizer(model, DataSet.array(samples), CrossEntropyCriterion(),
                  batch_size=256) \\
            .set_optim_method(SGD(0.1)) \\
            .set_validation(Trigger.every_epoch(), held_out,
                            [Top1Accuracy()], 256) \\
            .set_checkpoint("/ckpt", Trigger.every_epoch()) \\
            .set_end_when(Trigger.max_epoch(90)).optimize()

    Once ``Engine.init()`` has run, ``strategy`` defaults to
    :class:`DataParallel` over the Engine's group and the device to the
    Engine's; ``batch_size`` is then per process, and the dataset should be
    ``DataSet.array(samples, distributed=True)`` so that each rank feeds
    its own rows.
    """

    def __init__(self, model: Module, dataset, criterion: Criterion,
                 batch_size: Optional[int] = None,
                 end_trigger: Optional[Trigger] = None,
                 strategy: Optional[ShardingStrategy] = None, device=None):
        strategy, device = self._placement(strategy, device)
        self.device = resolve_device(device)
        self.strategy = strategy
        dataset = _as_dataset(dataset)
        if batch_size is not None:
            dataset = dataset.transform(
                SampleToMiniBatch(batch_size, drop_last=True))
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.end_trigger = end_trigger or Trigger.max_epoch(1)
        self.metrics = Metrics()
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset = None
        self.validation_methods: list = []
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.is_overwrite = True
        self.ckpt_keep_last: Optional[int] = None
        self.ckpt_keep_every_epochs: Optional[int] = None
        self._ckpt_keepers: set = set()
        self._kept_epoch_block = 0
        # release publication (set_checkpoint(publish=...))
        self.publish_dir: Optional[str] = None
        self.publish_every = 1
        self._publisher = None
        self._publish_count = 0
        self.grad_clip_const = None
        self.grad_clip_norm = None
        self.checkpoint_async = False
        self.train_summary = None
        self.validation_summary = None
        self.remat_policy = None
        self.grad_accum_steps = 1
        self.log_interval = 1
        # the straggler drop (set_drop_module_property)
        self.drop_percentage = 0.0
        self.max_drop_percentage = 0.0
        self.threshold_batch_size = 100
        self.warmup_iterations = 20
        self._iter_times: list = []
        self._drop_threshold = None
        self._dropped_in_window = 0
        self._iters_in_budget_window = 0
        self._supervise_cfg = None
        self._sup = None
        self._stager = None
        self._ckpt_futures: list = []
        self._ckpt_stream = None
        self._snap_event = None
        self._initial_blob = None
        self._preempted = False
        self._preemption_armed = False
        # set by resume_from, taken by the next optimize()
        self._resume_state = None
        self._resume_opt_state = None
        self._resume_rng = None
        self._forward = None
        self._to_host = HostCopy()
        #: [(method, result)] of the latest validation
        self.last_validation = None
        # this rank's method state after the last optimize() (its slices
        # under ZeRO), and the whole tree once final_opt_state gathered it
        self._final_state = self._final_whole = None
        #: the bytes of this rank's method state after the last optimize()
        #: (its slices under ZeRO)
        self.opt_state_bytes = None
        self._fused_update = False
        self._bucket_mb = 0.0

    def _placement(self, strategy, device):
        """(strategy, device) under the Engine's group: the strategy
        defaults to :class:`DataParallel` and the device to the Engine's
        (another raises); without a group a strategy raises."""
        return _group_strategy(strategy, device, type(self).__name__)

    def set_strategy(self, strategy: ShardingStrategy):
        """The sharding strategy of the next :meth:`optimize`
        (the reference's ``set_strategy``), checked as the constructor
        checks it."""
        self.strategy, _ = self._placement(strategy, self.device)
        return self

    @property
    def final_opt_state(self):
        """The method state after the last optimize(), whole.  Under ZeRO
        the first read all-gathers the slices: a collective, so every rank
        reads it at the same point; later reads return the same tree."""
        if self._final_whole is None and self._final_state is not None:
            self._final_whole = (
                self._final_state if self.strategy is None
                else self.strategy.full_state(self._final_state))
        return self._final_whole

    # -- fluent configuration (reference: optim/Optimizer.scala:98-255) --

    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    #: the reference's alias
    set_optim_methods = set_optim_method

    def set_end_when(self, trigger: Trigger):
        self.end_trigger = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None):
        """Score ``methods`` over ``dataset`` whenever ``trigger`` fires
        (after each iteration and each epoch boundary).  Samples are
        batched by ``batch_size`` (128 for Samples given without one), the
        last batch padded and cut back to its valid rows; a dataset of
        MiniBatches is taken as it is."""
        self.validation_trigger = trigger
        self.validation_dataset = _batched(dataset, batch_size)
        self.validation_methods = list(methods)
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       is_overwrite: bool = True, async_write: bool = False,
                       keep_last: Optional[int] = None,
                       keep_every_epochs: Optional[int] = None,
                       publish=None, publish_every: int = 1):
        """Write a snapshot pair into ``path`` (a local path, or one with a
        scheme ``file_io`` routes) whenever ``trigger`` fires.
        ``async_write`` takes the device-to-host copy on the step's path
        and leaves the pickle and the write to a background thread (a
        preemption's final snapshot is always synchronous).  ``keep_last``
        keeps only the newest K pairs; ``keep_every_epochs`` also keeps the
        first snapshot of every N-th epoch.  None defers to
        ``BIGDL_TORCH_CKPT_KEEP_LAST`` / ``_CKPT_KEEP_EVERY_EPOCHS``; 0
        keeps all.

        ``publish=True`` writes a release entry into ``path`` for every
        ``publish_every``-th snapshot (a string publishes into that
        directory instead): the feed a ``serve.DeployController`` watches.
        Rank 0 publishes, an asynchronous snapshot once its write is
        done."""
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self.is_overwrite = is_overwrite
        self.checkpoint_async = async_write
        self.ckpt_keep_last = keep_last
        self.ckpt_keep_every_epochs = keep_every_epochs
        self.publish_dir = (path if publish is True else (publish or None))
        self.publish_every = max(int(publish_every), 1)
        self._publisher = None
        return self

    def set_train_summary(self, summary):
        """Loss, LearningRate and Throughput every logged iteration, parameter
        histograms under the summary's ``"Parameters"`` trigger
        (``visualization.TrainSummary``)."""
        self.train_summary = summary
        return self

    def set_validation_summary(self, summary):
        """Every validation method's result at each validation
        (``visualization.ValidationSummary``)."""
        self.validation_summary = summary
        return self

    def set_remat(self, policy):
        """Rematerialize the training forward in the backward, segment by
        segment (the children of nested ``Sequential`` s): None (keep
        everything), ``"full"``, ``"conv_out"`` (keep only the
        convolutions' outputs) or a callable selective-checkpoint policy
        (``utils/remat.py``).  Gradients and buffers are the unremat run's
        bit for bit wherever the forward is deterministic."""
        self.remat_policy = remat.check_policy(policy)
        return self

    def set_gradient_accumulation(self, steps: int):
        """Split each batch into ``steps`` microbatches, their gradients
        averaged before the one update; the batch size must be a multiple
        of ``steps`` (checked when ``optimize()`` starts)."""
        if steps < 1:
            raise ValueError(f"set_gradient_accumulation: steps={steps}")
        self.grad_accum_steps = int(steps)
        return self

    def set_drop_module_property(self, drop_percentage: float,
                                 max_drop_percentage: float,
                                 batch_size: int = 100,
                                 warmup_iteration: int = 20):
        """Straggler drop (the reference's, ``:491-515``; BigDL's
        ``Optimizer.setDropModuleProperty``): the host data waits of the
        last ``batch_size`` iterations give a k-th largest threshold
        (k = window x ``drop_percentage``); an iteration whose wait exceeds
        it is skipped before the step, at most ``max_drop_percentage`` of a
        window."""
        if not 0 <= drop_percentage <= max_drop_percentage <= 1:
            raise ValueError("need 0 <= drop <= maxDrop <= 1")
        if batch_size < 2 or warmup_iteration < 0:
            raise ValueError("need batch_size >= 2 and warmup >= 0")
        self.drop_percentage = drop_percentage
        self.max_drop_percentage = max_drop_percentage
        self.threshold_batch_size = batch_size
        self.warmup_iterations = warmup_iteration
        return self

    def _straggler_check(self, data_wait: float, neval: int,
                         queue_depth: Optional[int] = None) -> bool:
        """Record this iteration's data wait; True drops the iteration
        (the reference's ``_straggler_check``, ``:517-566``).  The
        threshold comes from the window before this wait; a non-empty
        prefetch queue (``queue_depth`` > 0) means the consumer set the
        pace, and such an iteration is never dropped."""
        if queue_depth is not None:
            self.metrics.add("prefetch queue depth", float(queue_depth))
        if self.drop_percentage <= 0:
            return False
        window = self._iter_times
        if neval > self.warmup_iterations and \
                len(window) >= max(self.threshold_batch_size // 2, 1):
            k = max(int(len(window) * self.drop_percentage), 1)
            self._drop_threshold = kth_largest(window, k)
        else:
            self._drop_threshold = None
        window.append(data_wait)
        if len(window) > self.threshold_batch_size:
            del window[:len(window) - self.threshold_batch_size]
        # the drop budget resets once per window of iterations
        self._iters_in_budget_window += 1
        if self._iters_in_budget_window >= self.threshold_batch_size:
            self._iters_in_budget_window = 0
            self._dropped_in_window = 0
        if self._drop_threshold is None or \
                data_wait <= self._drop_threshold or queue_depth:
            return False
        if (self._dropped_in_window + 1) / self.threshold_batch_size > \
                self.max_drop_percentage:
            return False  # budget spent: train through it
        self._dropped_in_window += 1
        self.metrics.add("dropped iterations", 1.0)
        logger.info("straggler: dropping iteration %d (data wait %.3fs > "
                    "threshold %.3fs)", neval, data_wait,
                    self._drop_threshold)
        return True

    def set_log_interval(self, n: int):
        """Read the step's loss on the host every ``n`` iterations; in
        between, the previous step's loss is read after the next step is
        queued (``:1773-1783``), so those iterations never wait on the
        card."""
        if n < 1:
            raise ValueError(f"set_log_interval: n={n}")
        self.log_interval = int(n)
        return self

    def set_supervision(self, data=None, step=None, checkpoint=None,
                        validation=None, compile=None, default=None,
                        policy=None, report_dir=None, peer_dir=None,
                        peer_stale=None, poll_interval=None):
        """Arm the stall watchdog (``utils/supervisor.py``): per-phase
        deadlines in seconds for ``data`` (the loop's wait for a batch and
        the input worker), ``step``, ``checkpoint``, ``validation``,
        ``compile`` (each attempt's first step, unwatched by ``step``) and
        ``default``; an omitted phase falls back to the
        ``BIGDL_TORCH_SUPERVISE_*`` knobs, 0 disarms it.  A missed deadline
        writes a crash report into ``report_dir`` (default: the checkpoint
        path) and raises a ``StallError`` that the retry loop recovers from
        (``policy="raise"``) or exits the process (``"exit"``).  The
        multi-host arguments (``peer_dir``, ``peer_stale``) raise (ROADMAP
        queue A item 6)."""
        if peer_dir is not None or peer_stale is not None:
            raise NotImplementedError(supervision._PEER_HALF)
        self._supervise_cfg = {"data": data, "step": step,
                               "checkpoint": checkpoint,
                               "validation": validation,
                               "compile": compile, "default": default,
                               "policy": policy, "report_dir": report_dir,
                               "poll_interval": poll_interval}
        return self

    def _build_supervisor(self):
        """The Supervisor of this run, or None where no phase has a
        deadline (supervision off, the default)."""
        cfg = self._supervise_cfg or {}
        deadlines, env_default = supervision.env_deadlines()
        for phase in supervision.PHASES:
            v = cfg.get(phase)
            if v:
                deadlines[phase] = float(v)
            elif v == 0:
                deadlines.pop(phase, None)   # an explicit 0 disarms a knob
        default = cfg.get("default")
        if default is None:
            default = env_default
        if not deadlines and not default:
            return None
        return supervision.Supervisor(
            deadlines, default,
            report_dir=cfg.get("report_dir") or self.checkpoint_path,
            policy=cfg.get("policy"), rank=Engine.rank(),
            world=Engine.world(), poll_interval=cfg.get("poll_interval"))

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        self.grad_clip_norm = clip_norm
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float):
        self.grad_clip_const = (min_v, max_v)
        return self

    # -- the step ---------------------------------------------------------

    def _params(self):
        model = self.model
        if not model.built:
            model.build(self.device)
        params = list(model.parameters())
        for p in params:
            if p.device != self.device:
                raise ValueError(f"the model lives on {p.device}, the "
                                 f"optimizer runs on {self.device}: move it "
                                 f"with model.to({str(self.device)!r})")
        return params

    def _clip(self, grads):
        """Constant clipping, then L2-norm clipping (``:845-852``): the
        norm over every gradient in float32, on the device (no host
        read); under ZeRO over every rank's slices
        (``ShardingStrategy.sq_norm``)."""
        if self.grad_clip_const is not None:
            lo, hi = self.grad_clip_const
            grads = [g.clamp(lo, hi) for g in grads]
        if self.grad_clip_norm is not None:
            sq = (self.strategy or ShardingStrategy()).sq_norm(grads)
            scale = torch.clamp(self.grad_clip_norm
                                / (torch.sqrt(sq) + 1e-12), max=1.0)
            grads = [g * scale.to(g.dtype) for g in grads]
        return grads

    def _loss(self, inp, tgt, rng):
        """The training forward and loss of one (micro)batch, Dropout
        drawing from ``rng``.  Under a remat policy each segment of the
        model (:func:`_segments`) runs checkpointed on its own, so that
        the backward rebuilds one segment's activations at a time."""
        if self.remat_policy is None:
            with dropout_rng(rng):
                return self.criterion(self.model(inp), tgt)
        x = inp
        for seg in _segments(self.model):
            def fn(a, seg=seg):
                with dropout_rng(rng):
                    return seg(a)
            x = remat.checkpointed(fn, self.remat_policy, rng, x)
        with dropout_rng(rng):
            return self.criterion(x, tgt)

    def _microbatches(self, inp, tgt):
        """(input, target) of each microbatch: contiguous slices along
        axis 0, in order."""
        k = self.grad_accum_steps
        if k == 1:
            return [(inp, tgt)]
        if inp.shape[0] % k:
            raise ConfigurationError(
                f"gradient accumulation: batch {inp.shape[0]} not divisible "
                f"by accumulation steps {k}")
        m = inp.shape[0] // k
        return list(zip(inp.split(m), tgt.split(m)))

    def _step(self, params, opt_state, inp, tgt, lr, rng):
        """Forward and backward of each microbatch in order (Dropout
        drawing from ``rng``, under the remat policy), their gradients
        summed and divided by the accumulation steps, the strategy's
        reduction, the regularizer terms, the layer-wise scales, the wire
        cast, clipping and the update; returns (the loss over the global
        batch as a tensor, new method state).  The caller reads the loss
        only after the update is queued, so the host launches the rest
        while the card still runs the backward."""
        if self._snap_event is not None:
            # an asynchronous snapshot's copy must read this iteration's
            # tensors before the forward (BatchNorm's buffers) or the
            # update changes them
            torch.cuda.current_stream(self.device).wait_event(
                self._snap_event)
            self._snap_event = None
        for p in params:
            p.grad = None
        micro = self._microbatches(inp, tgt)
        strategy = self.strategy
        losses, armed = [], False
        for j, (x, t) in enumerate(micro):
            loss = self._loss(x, t, rng)
            losses.append(loss.detach())
            if j == len(micro) - 1:
                loss_all = (losses[0] if len(micro) == 1
                            else sum(losses) / len(micro))
                # a bucketed strategy reduces from the last backward
                armed = strategy is not None and strategy.arm(
                    params, loss_all, len(micro))
            loss.backward()
        loss, grads, own = loss_all, None, params
        if not armed:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            if len(micro) > 1:
                grads = [g / len(micro) for g in grads]
        if strategy is not None:
            grads, loss = strategy.reduce(grads, loss)
            own = strategy.own(params)
        grads = apply_regularizer_grads(self.model, params, grads, own)
        scales = self.model._grad_scales()
        if scales is not None:
            grads = [g * s for g, s in zip(grads, scales)]
        grads = wire_cast(grads, get_policy().wire_dtype, self._bucket_mb)
        grads = self._clip(grads)
        update = (self.optim_method.update_fused if self._fused_update
                  else self.optim_method.update)
        opt_state = update(grads, own, opt_state, lr)
        if strategy is not None:
            strategy.after_update(params)
        return loss, opt_state

    def _check_accum_batching(self):
        """At ``optimize()`` entry, not mid-epoch: every batcher's batch
        size divisible by the accumulation steps, and a last partial
        batch dropped or padded (the reference's
        ``_check_accum_batching``)."""
        k = self.grad_accum_steps
        if k <= 1:
            return
        try:
            n_samples = self.dataset.size()
        except Exception:  # noqa: BLE001 - the size is advisory here
            n_samples = None
        for b in _find_batchers(self.dataset):
            if b.batch_size % k:
                raise ConfigurationError(
                    f"gradient accumulation: batch_size {b.batch_size} not "
                    f"divisible by accumulation steps {k}")
            if not b.drop_last and not b.pad_last and \
                    (n_samples is None or n_samples % b.batch_size):
                raise ConfigurationError(
                    "gradient accumulation needs every batch divisible by "
                    f"{k}: set drop_last=True or pad_last=True on "
                    f"{type(b).__name__}")

    def _open_data_pipeline(self):
        """One epoch's batches: ``(iterator, pipe or None)``.  At depth 0
        the iterator yields host MiniBatches, which the loop copies itself
        (and fires the data chaos points for).  Otherwise a
        :class:`PrefetchIterator` yields ``(batch, staged)``, ``staged``
        being ``(input, target, event)`` from the Optimizer's
        :class:`_Stager`, or None with ``BIGDL_TORCH_PREFETCH_STAGE=0``;
        its worker fires ``data.stall`` and ``data.batch`` and beats the
        supervisor's ``data`` channel.  Staging is on by default on every
        rank: each rank copies only to its own device."""
        src = self.dataset.data(train=True)
        depth = prefetch_depth()
        if depth <= 0:
            return iter(src), None
        stager = None
        if config.get_bool("PREFETCH_STAGE", True):
            # the queue's batches, the one in the step and the one in the
            # worker's hands each hold a slot
            if self._stager is None or self._stager.device != self.device \
                    or len(self._stager._slots) != depth + 2:
                self._stager = _Stager(self.device, depth + 2)
            stager = self._stager

        def produce(batch):
            # one count per minibatch, as on the synchronous path; a
            # corrupt@ schedule poisons the batch before it is staged
            batch = chaos.transform("data.batch", batch)
            return batch, None if stager is None else stager(batch)

        pipe = PrefetchIterator(src, depth=depth, transform=produce,
                                pre_fire=lambda: chaos.fire("data.stall"),
                                name="bigdl-torch-prefetch",
                                supervisor=self._sup)
        return pipe, pipe

    @staticmethod
    def _observe_loss(lossf: float, state) -> float:
        """Every host read of the training loss: the ``step.loss_nan``
        chaos point may corrupt it, and a non-finite value raises
        :class:`NonFiniteLossError` into the retry loop."""
        lossf = chaos.transform("step.loss_nan", lossf)
        if not math.isfinite(lossf):
            raise NonFiniteLossError(
                f"non-finite training loss {lossf} observed at iteration "
                f"{state['neval']} (epoch {state['epoch']})")
        return lossf

    # -- validation -------------------------------------------------------

    def _maybe_validate(self, state):
        if self.validation_trigger is None or \
                not self.validation_trigger(state):
            return
        if self._sup is not None:
            self._sup.beat("validation")
        results = self._run_validation()
        # Trigger.plateau's observation counter: one validation, one tick
        state["val_obs"] = state.get("val_obs", 0) + 1
        for method, res in results:
            val, _ = res.result()
            logger.info("Validation %s: %s", method.name, res)
            if method.name in ("Top1Accuracy", "Top5Accuracy"):
                state["score"] = val
            elif method.name in ("Loss", "Perplexity"):
                state["val_loss"] = val
            state[method.name] = val
            if self.validation_summary is not None:
                self.validation_summary.add_scalar(method.name, val,
                                                   state["neval"] - 1)
        self.last_validation = results

    def _run_validation(self):
        """The validation methods over the validation dataset, in eval mode
        without autograd, the model back in training mode after; under a
        group, every rank's results summed.  Returns [(method, result)]."""
        if self._forward is None:
            self._forward = _Forward(self.model, self.device)
        model = self.model
        model.eval()
        try:
            totals = _score(self._forward, self.validation_dataset,
                            self.validation_methods, self._to_host)
        finally:
            model.train()
        if totals and totals[0] is None:
            raise ValueError("the validation dataset produced no batches")
        if Engine.group() is not None and totals:
            totals = _reduce_results(totals, self.device)
        return list(zip(self.validation_methods, totals))

    # -- checkpoints ------------------------------------------------------

    def _checkpoint_decision(self, state, preempt: bool) -> bool:
        """Whether to write a snapshot now: a preemption always does.
        Every rank decides alike: the triggers read the driver state,
        whose validation fields are summed over the group, and the
        preemption flag is reduced over it (:meth:`_global_preempted`)."""
        if self.checkpoint_path is None:
            return False
        return preempt or (self.checkpoint_trigger is not None
                           and bool(self.checkpoint_trigger(state)))

    def _global_preempted(self) -> bool:
        """The SIGTERM flag, under a group one all-reduce of it, so every
        rank stops at the same boundary; no collective unless preemption
        is armed (a checkpoint path, the same on every rank)."""
        pre = self._preempted
        if self._preemption_armed and Engine.group() is not None:
            flag = torch.tensor([float(pre)], device=self.device)
            pre = bool(Engine.all_reduce(flag, "preemption").item() > 0)
        return pre

    def _raise_ckpt_errors(self) -> None:
        """An asynchronous write that failed raises here, at the next
        boundary."""
        done = [f for f in self._ckpt_futures if f.done()]
        self._ckpt_futures = [f for f in self._ckpt_futures
                              if not f.done()]
        file_io.join_checkpoints(done)

    def _drain_ckpt_futures(self, context="preemption stop") -> None:
        """Join the pending asynchronous writes, logging a failure instead
        of raising it: recovery and shutdown go on with older snapshots."""
        try:
            file_io.join_checkpoints(self._ckpt_futures)
        except Exception as e:  # noqa: BLE001
            logger.warning("asynchronous checkpoint write failed before %s "
                           "(the older snapshots stand): %s", context, e)
        self._ckpt_futures = []

    def _fetch_async(self):
        """The tensor-to-numpy map of an asynchronous snapshot: on CUDA a
        pinned host copy issued on a side stream that first waits for all
        the work queued so far (this iteration's update), its numpy view
        returned before the copy lands, and the event after the copies
        (which the writer and the next step wait on); on the CPU a plain
        copy.  Returns (fetch, done): ``done()`` gives the event."""
        if self.device.type != "cuda":
            def fetch_cpu(t):
                t = t.detach()
                return (t.float() if t.dtype == torch.bfloat16
                        else t.clone()).numpy()
            return fetch_cpu, lambda: None
        if self._ckpt_stream is None:
            self._ckpt_stream = torch.cuda.Stream(self.device)
        side = self._ckpt_stream
        side.wait_stream(torch.cuda.current_stream(self.device))

        def fetch(t):
            t = t.detach()
            t.record_stream(side)
            with torch.cuda.stream(side):
                if t.dtype == torch.bfloat16:
                    t = t.float()   # exact; numpy has no bfloat16
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
            return host.numpy()

        def done():
            event = torch.cuda.Event()
            event.record(side)
            return event
        return fetch, done

    def _write_checkpoint(self, state, opt_state, rng, preempt=False):
        """``model.<n>`` and ``optimMethod.<n>`` for the last finished
        iteration n, written by rank 0 alone, then the retention.
        Asynchronous unless the reason is a preemption."""
        if self._sup is not None:
            self._sup.beat("checkpoint")
        if self.strategy is not None:
            # under ZeRO every rank all-gathers the slices before rank 0
            # writes the whole tree
            opt_state = self.strategy.full_state(opt_state)
        if Engine.rank() != 0:
            return
        neval = state["neval"] - 1
        is_async = self.checkpoint_async and not preempt
        fetch, done = self._fetch_async() if is_async else (None, None)
        params, net_state = to_reference_tree(self.model, fetch)
        # the generator of a rank's Dropout masks: only one rank writes, so
        # under a group the ranks reseed on resume instead
        rng_state = None
        if Engine.group() is None:
            rng_state = {"device": rng.device.type,
                         "state": rng.get_state().numpy().copy()}
        model_blob = {"params": params, "state": net_state}
        optim_blob = {"method": self.optim_method.state_dict(),
                      "opt_state": to_reference_opt_state(
                          self.model, self.optim_method, opt_state, fetch),
                      "rng_state": None,
                      "driver_state": {k: copy.deepcopy(v)
                                       for k, v in state.items()
                                       if not k.startswith("_")},
                      "torch_rng_state": rng_state}
        write = None
        if is_async:
            event = done()
            self._snap_event = event
            write = file_io.save_checkpoint_async(
                self.checkpoint_path, neval, model_blob, optim_blob,
                overwrite=self.is_overwrite, ready=event)
            self._ckpt_futures.append(write)
        else:
            file_io.save_checkpoint(self.checkpoint_path, neval, model_blob,
                                    optim_blob, overwrite=self.is_overwrite)
        logger.info("checkpoint %s at iteration %d -> %s%s",
                    "queued (async)" if is_async else "written", neval,
                    self.checkpoint_path,
                    " (preemption's final snapshot)" if preempt else "")
        if self.publish_dir:
            self._maybe_publish(neval, state, write)
        self._apply_retention(neval, state)

    def _maybe_publish(self, neval, state, write=None):
        """Every ``publish_every``-th snapshot becomes a release entry
        (``serve/continuous.ReleasePublisher``); ``write`` is the future of
        an asynchronous snapshot, published once it is done (never one
        that failed).  A failed publication is logged: training goes on
        and the deploy side sees no new release."""
        self._publish_count += 1
        if (self._publish_count - 1) % self.publish_every:
            return
        model_path = file_io._join(
            file_io._strip_file_scheme(self.checkpoint_path),
            f"model.{neval}")
        info = {"neval": int(neval), "epoch": int(state.get("epoch", 0)),
                "iteration": int(neval),
                "metrics": {k: float(v) for k, v in state.items()
                            if isinstance(v, (int, float))
                            and not k.startswith("_")}}

        def publish(fut=None):
            if fut is not None and (fut.cancelled()
                                    or fut.exception() is not None):
                return
            try:
                if self._publisher is None:
                    from ..serve.continuous import ReleasePublisher
                    self._publisher = ReleasePublisher(self.publish_dir)
                self._publisher.publish(model_path, **info)
            except Exception:  # noqa: BLE001 - downstream of training
                logger.exception("release publish for %s failed (training "
                                 "continues; the deploy controller sees "
                                 "no new release)", model_path)
        if write is not None:
            write.add_done_callback(publish)
        else:
            publish()

    def _apply_retention(self, neval, state):
        """Keep-last-K and keep-every-N-epochs pruning after each write;
        never fatal."""
        keep_last = self.ckpt_keep_last
        if keep_last is None:
            keep_last = config.get_int("CKPT_KEEP_LAST", 0)
        every = self.ckpt_keep_every_epochs
        if every is None:
            every = config.get_int("CKPT_KEEP_EVERY_EPOCHS", 0)
        if every > 0:
            block = state["epoch"] // every
            if block > self._kept_epoch_block:
                # the first snapshot at or past every N-th epoch boundary
                # becomes a permanent rollback point
                self._kept_epoch_block = block
                self._ckpt_keepers.add(neval)
        if keep_last > 0:
            try:
                file_io.prune_checkpoints(self.checkpoint_path, keep_last,
                                          keep=self._ckpt_keepers)
            except Exception as e:  # noqa: BLE001 - retention never fatal
                logger.warning("retention pruning failed (non-fatal): %s",
                               e)

    # -- resume -----------------------------------------------------------

    def resume_from(self, model_path: str,
                    optim_path: Optional[str] = None) -> "Optimizer":
        """Resume from a snapshot pair (the reference's ``--model
        model.<n> --state optimMethod.<n>``); with only a model snapshot
        the method and driver start fresh on the loaded weights.  Set the
        optimization method first.  A snapshot that fails verification is
        quarantined (``.corrupt``) and, where the path is a ``model.<n>``
        of a lineage, the newest valid older pair is loaded instead,
        loudly; with none, :class:`~bigdl_torch.utils.file_io.
        CorruptCheckpoint` propagates."""
        try:
            return self._load_snapshot(model_path, optim_path)
        except file_io.CorruptCheckpoint as e:
            logger.warning("snapshot %s failed verification (%s); "
                           "quarantining and falling back to the newest "
                           "valid snapshot", model_path, e)
            file_io.quarantine_checkpoint(model_path, optim_path)
            base, name = (os.path.dirname(model_path),
                          os.path.basename(model_path))
            m = re.fullmatch(r"model\.(\d+)", name)
            if base and m and self._lineage_resume(base,
                                                   below=int(m.group(1))):
                return self
            raise

    def _load_snapshot(self, model_path: str,
                       optim_path: Optional[str] = None) -> "Optimizer":
        """Read and check one snapshot pair, then install it: both blobs
        are loaded and held to the model and the method before any state
        changes."""
        blob = file_io.load(model_path)
        if not isinstance(blob, dict) or "params" not in blob \
                or "state" not in blob:
            raise file_io.CorruptCheckpoint(
                f"{model_path}: not a model snapshot blob")
        oblob = None
        if optim_path is not None:
            oblob = file_io.load(optim_path)
            if not isinstance(oblob, dict) or "method" not in oblob \
                    or "driver_state" not in oblob:
                raise file_io.CorruptCheckpoint(
                    f"{optim_path}: not an optimMethod snapshot blob")
        self._params()      # the model built on this optimizer's device
        check_reference_tree(self.model, blob["params"], blob["state"])
        opt_state = None
        if oblob is not None and oblob.get("opt_state") is not None:
            opt_state = load_reference_opt_state(
                self.model, self.optim_method, oblob["opt_state"])
        load_reference_tree(self.model, blob["params"], blob["state"])
        self._resume_state = self._resume_opt_state = None
        self._resume_rng = None
        if oblob is not None:
            self.optim_method.load_state_dict(oblob["method"])
            self._resume_state = dict(oblob["driver_state"])
            self._resume_opt_state = opt_state
            self._resume_rng = oblob.get("torch_rng_state")
            if self._resume_rng is None:
                logger.info("%s carries no torch generator state%s: the "
                            "Dropout generator is seeded as at a start",
                            optim_path, " (a JAX snapshot's rng_state has "
                            "no torch counterpart)"
                            if oblob.get("rng_state") is not None else "")
        return self

    def _lineage_resume(self, path: str, below: Optional[int] = None) \
            -> bool:
        """Walk the lineage newest first, quarantining corrupt snapshots,
        until one loads (True) or none is left (False); ``below`` keeps to
        snapshots older than that neval."""
        skipped = []
        for mp, op, n in file_io.checkpoint_lineage(path):
            if below is not None and n >= below:
                continue
            try:
                self._load_snapshot(mp, op)
            except file_io.CorruptCheckpoint as e:
                logger.warning("checkpoint %s failed verification (%s); "
                               "quarantining and walking back the lineage",
                               mp, e)
                file_io.quarantine_checkpoint(mp, op)
                skipped.append(n)
                continue
            logger.warning("resumed from %s (iteration %d)%s", mp, n,
                           f", past corrupt snapshot(s) {skipped}"
                           if skipped else "")
            return True
        return False

    def _dropout_generator(self):
        """The Dropout masks' generator on the training device: seeded as
        at a start, or the resumed snapshot's state where it has one for
        this kind of device."""
        rng = torch.Generator(device=self.device).manual_seed(
            dropout_seed(Engine.rank()))
        saved, self._resume_rng = self._resume_rng, None
        if saved is not None:
            if saved["device"] == self.device.type and Engine.group() is None:
                rng.set_state(torch.from_numpy(np.asarray(saved["state"],
                                                          np.uint8)))
            else:
                logger.warning("the snapshot's %s generator state does not "
                               "fit a %s run: the Dropout generator is "
                               "seeded as at a start", saved["device"],
                               "group" if Engine.group() is not None
                               else self.device.type)
        return rng

    # -- recovery ---------------------------------------------------------

    def _host_blob(self):
        """A host copy of what ``optimize()`` starts from: the parameters,
        the buffers, the method state, the driver state and the Dropout
        generator's state (the reference's ``_initial_blob``)."""
        model = self.model
        opt = self._resume_opt_state
        return {"params": [p.detach().to("cpu", copy=True)
                           for p in model.parameters()],
                "buffers": [b.detach().to("cpu", copy=True)
                            for b in model.buffers()],
                "opt_state": None if opt is None else to_reference_opt_state(
                    model, self.optim_method, opt),
                "state": copy.deepcopy(self._resume_state),
                "rng": copy.deepcopy(self._resume_rng)}

    def _restore_blob(self, blob):
        """Put the starting point back: the tensors in place, the rest as
        if ``resume_from`` had just set it."""
        with torch.no_grad():
            for t, h in zip(itertools.chain(self.model.parameters(),
                                            self.model.buffers()),
                            blob["params"] + blob["buffers"]):
                t.copy_(h)
        self._resume_opt_state = (
            None if blob["opt_state"] is None else load_reference_opt_state(
                self.model, self.optim_method, blob["opt_state"]))
        self._resume_state = copy.deepcopy(blob["state"])
        self._resume_rng = copy.deepcopy(blob["rng"])

    def _recover_from_checkpoint(self):
        """After a failed attempt: the newest valid snapshot of the
        lineage, or, with none, the starting point ``optimize()`` copied.
        The failed attempt's tensors were updated in place, so it never
        goes on from them."""
        if self._sup is not None:
            # recovery runs under the checkpoint deadline, not the step's
            self._sup.beat("checkpoint")
        # pending writes land (or fail) before the lineage is read
        self._drain_ckpt_futures(context="recovery")
        self._snap_event = None
        if self._lineage_resume(self.checkpoint_path):
            return
        logger.warning("no valid checkpoint; restoring the starting weights "
                       "for the retry")
        self._restore_blob(self._initial_blob)

    # -- the loop ---------------------------------------------------------

    def _boundary(self, state, opt_state, rng):
        """After an iteration or an epoch: validation first (skipped when
        preempted), so that a trigger reading the score sees this
        boundary's, then the checkpoint; a preemption then stops the
        run."""
        self._raise_ckpt_errors()
        preempt = self._global_preempted()
        if not preempt:
            self._maybe_validate(state)
        if self._checkpoint_decision(state, preempt):
            self._write_checkpoint(state, opt_state, rng, preempt=preempt)
        if preempt:
            self._drain_ckpt_futures()
            logger.warning("preemption signal observed: final checkpoint "
                           "written, stopping")
            raise TrainingPreempted(
                "SIGTERM: final checkpoint written at iteration "
                f"{state['neval'] - 1}; resume with Optimizer.resume_from")

    def optimize(self) -> Module:
        """Run until the end trigger fires, retrying failed attempts from
        the checkpoint lineage; returns the trained model."""
        self._initial_blob = None
        self._preempted = False
        self._preemption_armed = (
            self.checkpoint_path is not None
            and config.get_bool("PREEMPTION_CHECKPOINT", True))
        old_handler = None
        if self._preemption_armed:
            def on_sigterm(signum, frame):
                # a flag only: the next boundary acts on it
                self._preempted = True
            try:
                old_handler = signal.signal(signal.SIGTERM, on_sigterm)
            except ValueError:
                pass   # not the main thread: no handler
        self._sup = self._build_supervisor()
        if self._sup is not None:
            self._sup.beat("data")
            self._sup.start()
            supervision.set_active(self._sup)
        try:
            return self._optimize_with_retry()
        finally:
            if self._sup is not None:
                self._sup.stop()
                self._sup = None
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)

    def _optimize_with_retry(self) -> Module:
        retries, last_failure = 0, None
        max_retries = config.retry_times()
        window = config.retry_time_interval()
        while True:
            try:
                return self._optimize_impl()
            except (KeyboardInterrupt, ConfigurationError,
                    TrainingPreempted):
                raise
            except Exception:
                now = time.monotonic()
                # the count starts over when failures are farther apart
                # than the window (DistriOptimizer.scala:752)
                if last_failure is not None and now - last_failure > window:
                    retries = 0
                last_failure = now
                retries += 1
                if retries > max_retries or self.checkpoint_path is None:
                    raise
                logger.exception("training failed; recovering from the "
                                 "checkpoint lineage (retry %d/%d)",
                                 retries, max_retries)
                self._recover_from_checkpoint()

    def _optimize_impl(self) -> Module:
        self._check_accum_batching()
        params = self._params()
        optim = self.optim_method
        strategy = self.strategy
        self._bucket_mb = wire_bucket_mb()
        if strategy is not None:
            strategy.setup(self.model, optim, self._bucket_mb)
        self._fused_update = (config.get_bool("FUSED_UPDATE", False)
                              and optim.supports_fused)
        if self._initial_blob is None and self.checkpoint_path is not None:
            self._initial_blob = self._host_blob()
        opt_state, self._resume_opt_state = self._resume_opt_state, None
        if opt_state is None:
            opt_state = optim.init_state(
                params if strategy is None else strategy.own(params))
        elif strategy is not None:
            opt_state = strategy.shard_state(opt_state)
        # driver state (the reference's optimMethod.state Table)
        state, self._resume_state = self._resume_state, None
        if state is None:
            state = {"epoch": 1, "neval": 1, "evalCounter": 0,
                     "loss": float("nan")}
        optim.hyper = state
        self.model.train()
        rng = self._dropout_generator()
        beat = self._sup.beat if self._sup is not None else (lambda _p: None)
        first_step = True
        while not self.end_trigger(state):
            self.dataset.shuffle()
            records = 0
            # the step whose loss the host has not read yet (:1773-1783)
            pending = None
            data, pipe = self._open_data_pipeline()
            try:
                while True:
                    chaos.at_position(state["epoch"], state["neval"])
                    beat("data")
                    if pipe is None:
                        chaos.fire("data.stall")
                    qdepth = pipe.queue_depth() if pipe is not None else None
                    t0 = time.perf_counter()
                    item = next(data, None)
                    if item is None or self.end_trigger(state):
                        break
                    if pipe is None:
                        batch, staged = chaos.transform("data.batch",
                                                        item), None
                    else:
                        batch, staged = item
                    t1 = time.perf_counter()
                    self.metrics.add("get batch time average", t1 - t0)
                    if self._straggler_check(t1 - t0, state["neval"],
                                             queue_depth=qdepth):
                        continue
                    # the first step of an attempt builds the kernels
                    beat("compile" if first_step else "step")
                    first_step = False
                    chaos.fire("step.stall")
                    if staged is None:
                        inp = _put_batch(batch.get_input(), self.device)
                        tgt = _put_batch(batch.get_target(), self.device)
                    else:
                        inp, tgt = _consume(staged)
                    lr = float(optim.get_learning_rate(state))
                    loss, opt_state = self._step(params, opt_state, inp, tgt,
                                                 lr, rng)
                    # the previous step's loss, long computed: no wait
                    if pending is not None:
                        state["loss"] = self._observe_loss(float(pending),
                                                           state)
                    pending = loss
                    n = batch.size()
                    records += n
                    if state["neval"] % self.log_interval == 0:
                        state["loss"] = self._observe_loss(float(loss), state)
                        pending = None
                        dt = time.perf_counter() - t1
                        self.metrics.add("computing time average", dt)
                        logger.info("Epoch %d [iteration %d] loss %.6f lr "
                                    "%.5g throughput %.1f records/s",
                                    state["epoch"], state["neval"],
                                    state["loss"], lr, n / max(dt, 1e-9))
                        self._summarize(state, lr, n / max(dt, 1e-9))
                    self._histograms(state)
                    state["neval"] += 1
                    state["evalCounter"] += 1
                    self._boundary(state, opt_state, rng)
            finally:
                if pipe is not None:
                    pipe.close()
            if pending is not None:
                state["loss"] = self._observe_loss(float(pending), state)
            if records == 0:
                raise ConfigurationError(
                    "epoch produced no minibatches: the dataset is smaller "
                    "than the batch size with drop_last=True")
            state["epoch"] += 1
            # every_epoch triggers see the epoch's increment here
            self._boundary(state, opt_state, rng)
        file_io.join_checkpoints(self._ckpt_futures)
        self._ckpt_futures = []
        self.opt_state_bytes = opt_state_nbytes(opt_state)
        self._final_state, self._final_whole = opt_state, None
        self._initial_blob = None   # the run succeeded: drop the copy
        return self.model

    def _summarize(self, state, lr, throughput):
        """The train summary's scalars, on a logged iteration."""
        summary = self.train_summary
        if summary is None:
            return
        neval = state["neval"]
        summary.add_scalar("Loss", state["loss"], neval)
        summary.add_scalar("LearningRate", lr, neval)
        summary.add_scalar("Throughput", throughput, neval)

    def _histograms(self, state):
        """When the train summary's ``"Parameters"`` trigger fires, a
        histogram of every parameter (the only time they are copied to the
        host)."""
        summary = self.train_summary
        if summary is None:
            return
        trig = summary.get_summary_trigger("Parameters")
        if trig is not None and trig(state):
            for name, p in _param_paths(self.model):
                summary.add_histogram(name, to_host(p), state["neval"])


class DistriOptimizer(Optimizer):
    """The reference's name (optim/DistriOptimizer.scala:689): the base
    :class:`Optimizer` already trains over the Engine's group."""


class LocalOptimizer(Optimizer):
    """Training on one device (optim/LocalOptimizer.scala:41): no
    sharding strategy, and no Engine group of more than one rank (the
    BatchNorm statistics would reach for the other ranks)."""

    def _placement(self, strategy, device):
        if strategy is not None:
            raise ValueError(f"LocalOptimizer trains on one device; it "
                             f"takes no {type(strategy).__name__}")
        if Engine.world() > 1:
            raise RuntimeError(f"LocalOptimizer trains on one device, the "
                               f"Engine's group has {Engine.world()} ranks:"
                               " use Optimizer or DistriOptimizer")
        if device is None:
            device = Engine.device()
        return None, device


def _group_strategy(strategy, device, who):
    """Under the Engine's group: the strategy (default
    :class:`DataParallel`) and the device (default the Engine's; another
    raises).  Without a group a strategy raises."""
    if Engine.group() is not None:
        strategy = strategy or DataParallel()
        if device is None:
            device = Engine.device()
        if resolve_device(device) != Engine.device():
            raise ValueError(f"the Engine's rank runs on {Engine.device()},"
                             f" not on {device}")
    elif strategy is not None:
        raise RuntimeError(f"{who} with {type(strategy).__name__} needs "
                           "the Engine's data group: call Engine.init()")
    return strategy, device


def _block(a: np.ndarray, lo: int, m: int) -> np.ndarray:
    """Rows [lo, lo + m) of ``a``, the rows past its end copies of its
    last row (the reference's padding)."""
    rows = a[lo:lo + m]
    if len(rows) < m:
        rows = np.concatenate([rows, np.repeat(a[-1:], m - len(rows),
                                               axis=0)])
    return rows


class _Forward:
    """The eval forward that ``Predictor``, ``Evaluator``, validation and
    the serving replicas share: online answers are the same arithmetic as
    bulk prediction.  Builds the model on ``device`` if it has no weights
    yet; a built model must already live there (it is never moved behind
    the caller's back).

    Under a ``strategy`` (the reference's ``_ShardedForward``) a batch is
    padded to a multiple of ``strategy.batch_shard_count()`` with copies of
    its last row and each rank forwards its own block of rows; with
    ``gather`` the blocks are all-gathered back into order on every rank,
    else each rank keeps its own (:meth:`rows` says which) and the scores
    are summed over the group (:func:`_reduce_results`)."""

    def __init__(self, model: Module, device=None, strategy=None,
                 gather: bool = True):
        self.device = resolve_device(device)
        if not model.built:
            model.build(self.device)
        for p in model.parameters():
            if p.device != self.device:
                raise ValueError(f"the model lives on {p.device}, the "
                                 f"engine runs on {self.device}: move it "
                                 f"with model.to({str(self.device)!r})")
            break
        self.model = model
        self.shards = (1 if strategy is None
                       else strategy.batch_shard_count())
        self.gather = gather

    def __call__(self, inp):
        """Forward one host batch in eval mode; returns (device output,
        its row count: the batch's, or the rank's block's).  The caller
        restores training mode where it needs it."""
        if self.shards > 1:
            inp = np.asarray(inp)
            n = inp.shape[0]
            m = -(-n // self.shards)
            inp = _block(inp, Engine.rank() * m, m)
        x = _put_batch(inp, self.device)
        self.model.eval()
        with torch.inference_mode():
            out = self.model(x)
            if self.shards > 1 and self.gather:
                out = (_gather_rows(out) if not isinstance(out, (list, tuple))
                       else [_gather_rows(t) for t in out])
                return out, n
        return out, x.shape[0]

    def rows(self, valid: int, n: int):
        """(first row, count) of a batch's ``valid`` rows that an output
        of ``n`` rows holds."""
        if self.shards == 1 or self.gather:
            return 0, min(valid, n)
        lo = Engine.rank() * n
        return lo, max(0, min(n, valid - lo))


def _gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's block of rows, in rank order (bf16 widened to
    float32 first, as the host copy would)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    t = t.contiguous()
    out = torch.empty((Engine.world() * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    return Engine.all_gather(out, t, "predict")


class Evaluator:
    """Bulk inference and metrics over a dataset (reference:
    optim/Evaluator.scala:37) on one device: the CUDA device, or
    ``device="cpu"``.  Under the Engine's group (``strategy`` defaults to
    its :class:`DataParallel`) every rank forwards its own block of each
    batch and scores its own rows, and the results are summed over the
    group: every rank gets the same answer."""

    def __init__(self, model: Module, strategy: ShardingStrategy = None,
                 device=None):
        self.model = model
        strategy, device = _group_strategy(strategy, device, "Evaluator")
        self._engine = _Forward(model, device, strategy, gather=False)
        self._to_host = HostCopy()

    def test(self, dataset, methods: Sequence[ValidationMethod],
             batch_size: Optional[int] = None):
        """[(method, result)] over ``dataset`` (a DataSet of Samples or
        MiniBatches, or a list of Samples), each batch cut to its valid
        rows."""
        totals = _score(self._engine, _batched(dataset, batch_size),
                        methods, self._to_host)
        # every rank saw the same batches: all of them or none hold results
        if self._engine.shards > 1 and totals and totals[0] is not None:
            totals = _reduce_results(totals, self._engine.device)
        return list(zip(methods, totals))


class Predictor:
    """Bulk prediction (reference: optim/Predictor.scala:34): over an
    array in chunks of ``batch_size`` rows, or over a DataSet or a list of
    Samples, batched with the last batch padded and cut back.  Under the
    Engine's group each rank forwards its own block of each batch and the
    blocks are all-gathered back into order: every rank gets every row."""

    def __init__(self, model: Module, batch_size: int = 128,
                 strategy: ShardingStrategy = None, device=None):
        self.model = model
        self.batch_size = batch_size
        strategy, device = _group_strategy(strategy, device, "Predictor")
        self._engine = _Forward(model, device, strategy)
        self._to_host = HostCopy()

    def predict(self, dataset) -> np.ndarray:
        x = _as_dataset(dataset)
        if isinstance(x, AbstractDataSet):
            data = x.transform(SampleToMiniBatch(self.batch_size,
                                                 pad_last=True))
            outs = [out for out, *_ in _forward_batches(
                self._engine, data.data(train=False), self._to_host)]
            return np.concatenate(outs, axis=0)
        x = np.asarray(x)
        outs = []
        for i in range(0, len(x), self.batch_size):
            chunk = x[i:i + self.batch_size]
            out, _ = self._engine(chunk)
            outs.append(self._to_host(out[:len(chunk)]))
        return np.concatenate(outs, axis=0)

    def predict_class(self, dataset) -> np.ndarray:
        return np.argmax(self.predict(dataset), axis=-1)


class Validator:
    """Dataset evaluation facade (reference: optim/Validator.scala:34,
    DistriValidator.scala:35, LocalValidator), a thin wrapper over
    :class:`Evaluator`."""

    def __init__(self, model: Module, dataset, device=None):
        self.model = model
        self.dataset = dataset
        self.device = device

    def test(self, methods, batch_size: int = 128):
        return Evaluator(self.model, device=self.device).test(
            self.dataset, methods, batch_size=batch_size)


#: the reference's names (one device or a group, the same class)
DistriValidator = Validator
LocalValidator = Validator
