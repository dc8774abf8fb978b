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

Not ported yet: validation (``Evaluator``, ``Top1Accuracy``), checkpoints
and the retry loop, regularizers, gradient clipping and accumulation,
remat, the prefetch pipeline, supervision and chaos points, and the
strategies other than ``DataParallel``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..common import get_policy, resolve_device
from ..dataset import DataSet, Sample, SampleToMiniBatch
from ..nn.criterion import Criterion
from ..nn.module import Module
from ..parallel.sharding import DataParallel, ShardingStrategy
from ..parallel.wire import wire_cast
from ..utils.engine import Engine
from .method import SGD, OptimMethod
from .trigger import Trigger

__all__ = ["Optimizer", "Predictor", "NonFiniteLossError", "to_host"]


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array.  numpy has no bfloat16, so a
    bfloat16 tensor widens to float32 first; that widening is exact."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class NonFiniteLossError(RuntimeError):
    """The host-observed training loss went NaN or Inf."""


def _as_dataset(dataset):
    """A plain sequence of Samples becomes a DataSet; other inputs pass
    through (the reference's ``_as_dataset``)."""
    if isinstance(dataset, (list, tuple)) and dataset and \
            isinstance(dataset[0], Sample):
        return DataSet.array(list(dataset))
    return dataset


def _to_device(x, device):
    return torch.as_tensor(np.asarray(x)).to(device)


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

    def _step(self, params, opt_state, batch, lr):
        """Forward in training mode, loss, backward, the strategy's
        reduction, the wire cast and the update; returns (the loss over
        the global batch as a tensor, new method state).  The caller reads
        the loss only after the update is queued, so the host launches the
        wire cast and the update while the card still runs the backward."""
        inp = _to_device(batch.get_input(), self.device)
        tgt = _to_device(batch.get_target(), self.device)
        for p in params:
            p.grad = None
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
        while not self.end_trigger(state):
            self.dataset.shuffle()
            records = 0
            for batch in self.dataset.data(train=True):
                if self.end_trigger(state):
                    break
                lr = float(optim.get_learning_rate(state))
                loss, opt_state = self._step(params, opt_state, batch, lr)
                state["loss"] = self._observe_loss(float(loss), state)
                records += batch.size()
                state["neval"] += 1
                state["evalCounter"] += 1
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
        x = torch.as_tensor(np.asarray(inp)).to(self.device)
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

    def predict(self, x) -> np.ndarray:
        x = np.asarray(x)
        outs = []
        for i in range(0, len(x), self.batch_size):
            out, _ = self._engine(x[i:i + self.batch_size])
            outs.append(to_host(out))
        return np.concatenate(outs, axis=0)
