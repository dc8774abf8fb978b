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
``nn/normalization.py``).

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

Not ported yet: validation (``Evaluator``, ``Top1Accuracy``), checkpoints
and the retry loop, regularizers, gradient clipping and accumulation,
remat, supervision and chaos points, and the strategies other than
``DataParallel``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..common import get_policy, resolve_device
from ..dataset import DataSet, Sample, SampleToMiniBatch
from ..dataset.prefetch import PrefetchIterator, prefetch_depth
from ..nn.criterion import Criterion
from ..nn.dropout import dropout_rng
from ..nn.module import Module
from ..parallel.sharding import DataParallel, ShardingStrategy
from ..parallel.wire import wire_cast
from ..utils import config
from ..utils.engine import Engine
from .method import SGD, OptimMethod
from .metrics import Metrics
from .trigger import Trigger

__all__ = ["Optimizer", "Predictor", "NonFiniteLossError", "HostCopy",
           "to_host"]


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
    CPU tensor goes through :func:`to_host`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buf: Optional[torch.Tensor] = None
        self._stream = None
        self._done = None

    def __call__(self, t: torch.Tensor) -> np.ndarray:
        if t.device.type != "cuda":
            return to_host(t)
        t = t.detach()
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
            self._stream.wait_stream(torch.cuda.current_stream(t.device))
            with torch.cuda.stream(self._stream):
                stage.copy_(t, non_blocking=True)
                self._done.record()
            self._done.synchronize()
            out = torch.empty(t.shape, dtype=t.dtype)
            out.copy_(stage)
        return out.numpy()


class NonFiniteLossError(RuntimeError):
    """The host-observed training loss went NaN or Inf."""


def _as_dataset(dataset):
    """A plain sequence of Samples becomes a DataSet; other inputs pass
    through (the reference's ``_as_dataset``)."""
    if isinstance(dataset, (list, tuple)) and dataset and \
            isinstance(dataset[0], Sample):
        return DataSet.array(list(dataset))
    return dataset


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
    rewritten only after its previous copy's event has completed."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self._slots = [{"bufs": [None, None], "event": None}
                       for _ in range(slots)]
        self._next = 0
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

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


class Optimizer:
    """Trains ``model`` on ``dataset`` against ``criterion`` (reference:
    optim/Optimizer.scala:42 and the loop of DistriOptimizer.scala) on one
    device: the CUDA device, or ``device="cpu"``; with neither it raises.
    An unbuilt model is built there; a built one must already live there.

        Optimizer(model, DataSet.array(samples), CrossEntropyCriterion(),
                  batch_size=256) \\
            .set_optim_method(SGD(0.1)) \\
            .set_end_when(Trigger.max_iteration(100)).optimize()

    Once ``Engine.init()`` has run, ``strategy`` defaults to
    :class:`DataParallel` over the Engine's group and the device to the
    Engine's; ``batch_size`` is then per process, and the dataset should be
    ``DataSet.array(samples, distributed=True)`` so that each rank feeds
    its own rows.
    """

    def __init__(self, model: Module, dataset, criterion: Criterion,
                 batch_size: Optional[int] = None,
                 end_trigger: Optional[Trigger] = None, device=None,
                 strategy: Optional[ShardingStrategy] = None):
        if Engine.group() is not None:
            strategy = strategy or DataParallel()
            if device is None:
                device = Engine.device()
            if resolve_device(device) != Engine.device():
                raise ValueError(f"the Engine's rank runs on "
                                 f"{Engine.device()}, not on {device}")
        elif strategy is not None:
            raise RuntimeError(f"{type(strategy).__name__} needs the "
                               "Engine's data group: call Engine.init()")
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

    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger):
        self.end_trigger = trigger
        return self

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

    def _step(self, params, opt_state, inp, tgt, lr, rng):
        """Forward in training mode (Dropout drawing from ``rng``), loss,
        backward, the strategy's reduction, the wire cast and the update;
        returns (the loss over the global batch as a tensor, new method
        state).  The caller reads the loss only after the update is queued,
        so the host launches the wire cast and the update while the card
        still runs the backward."""
        for p in params:
            p.grad = None
        with dropout_rng(rng):
            loss = self.criterion(self.model(inp), tgt)
        loss.backward()
        loss = loss.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if self.strategy is not None:
            grads, loss = self.strategy.reduce(grads, loss)
        grads = wire_cast(grads, get_policy().wire_dtype)
        opt_state = self.optim_method.update(grads, params, opt_state, lr)
        return loss, opt_state

    def _open_data_pipeline(self):
        """One epoch's batches: ``(iterator, pipe or None)``.  At depth 0
        the iterator yields host MiniBatches, which the loop copies itself.
        Otherwise a :class:`PrefetchIterator` yields ``(batch, staged)``,
        ``staged`` being ``(input, target, event)`` from :class:`_Stager`,
        or None with ``BIGDL_TORCH_PREFETCH_STAGE=0``.  Staging is on by
        default on every rank: each rank copies only to its own device."""
        src = self.dataset.data(train=True)
        depth = prefetch_depth()
        if depth <= 0:
            return iter(src), None
        # the queue's batches, the one in the step and the one in the
        # worker's hands each hold a slot
        stager = (_Stager(self.device, depth + 2)
                  if config.get_bool("PREFETCH_STAGE", True) else None)

        def produce(batch):
            return batch, None if stager is None else stager(batch)

        pipe = PrefetchIterator(src, depth=depth, transform=produce,
                                name="bigdl-torch-prefetch")
        return pipe, pipe

    @staticmethod
    def _observe_loss(lossf: float, state) -> float:
        if not math.isfinite(lossf):
            raise NonFiniteLossError(
                f"non-finite training loss {lossf} observed at iteration "
                f"{state['neval']} (epoch {state['epoch']})")
        return lossf

    def optimize(self) -> Module:
        """Run until the end trigger fires; returns the trained model."""
        params = self._params()
        if self.strategy is not None:
            self.strategy.setup(self.model)
        optim = self.optim_method
        opt_state = optim.init_state(params)
        # driver state (the reference's optimMethod.state Table)
        state = {"epoch": 1, "neval": 1, "evalCounter": 0,
                 "loss": float("nan")}
        optim.hyper = state
        self.model.train()
        # the Dropout masks' generator, on the training device
        rng = torch.Generator(device=self.device).manual_seed(
            dropout_seed(Engine.rank()))
        while not self.end_trigger(state):
            self.dataset.shuffle()
            records = 0
            data, pipe = self._open_data_pipeline()
            try:
                while True:
                    t0 = time.perf_counter()
                    item = next(data, None)
                    if item is None or self.end_trigger(state):
                        break
                    if pipe is None:
                        batch, staged = item, None
                    else:
                        batch, staged = item
                    t1 = time.perf_counter()
                    self.metrics.add("get batch time average", t1 - t0)
                    if staged is None:
                        inp = _put_batch(batch.get_input(), self.device)
                        tgt = _put_batch(batch.get_target(), self.device)
                    else:
                        inp, tgt = _consume(staged)
                    lr = float(optim.get_learning_rate(state))
                    loss, opt_state = self._step(params, opt_state, inp, tgt,
                                                 lr, rng)
                    state["loss"] = self._observe_loss(float(loss), state)
                    self.metrics.add("computing time average",
                                     time.perf_counter() - t1)
                    records += batch.size()
                    state["neval"] += 1
                    state["evalCounter"] += 1
            finally:
                if pipe is not None:
                    pipe.close()
            if records == 0:
                raise ValueError(
                    "epoch produced no minibatches: the dataset is smaller "
                    "than the batch size with drop_last=True")
            state["epoch"] += 1
        return self.model


class _Forward:
    """The eval forward that ``Predictor`` and the serving replicas share:
    online answers are the same arithmetic as bulk prediction.  Builds the
    model on ``device`` if it has no weights yet; a built model must
    already live there (it is never moved behind the caller's back)."""

    def __init__(self, model: Module, device=None):
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

    def __call__(self, inp):
        """Forward one host batch; returns (device output, row count)."""
        x = _put_batch(inp, self.device)
        self.model.eval()
        with torch.inference_mode():
            out = self.model(x)
        return out, x.shape[0]


class Predictor:
    """Bulk prediction over an array of samples (reference:
    optim/Predictor.scala:34), in chunks of ``batch_size`` rows."""

    def __init__(self, model: Module, batch_size: int = 128, device=None):
        self.model = model
        self.batch_size = batch_size
        self._engine = _Forward(model, device)
        self._to_host = HostCopy()

    def predict(self, x) -> np.ndarray:
        x = np.asarray(x)
        outs = []
        for i in range(0, len(x), self.batch_size):
            out, _ = self._engine(x[i:i + self.batch_size])
            outs.append(self._to_host(out))
        return np.concatenate(outs, axis=0)
