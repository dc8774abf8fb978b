"""Loss functions: ``ClassNLLCriterion``, ``CrossEntropyCriterion`` and
``TimeDistributedCriterion``.

Counterpart of ``bigdl_tpu/nn/criterion.py`` (and its ``Criterion`` base
in ``nn/module.py``) for what the training slice uses.  A criterion's core
is ``loss(output, target) -> scalar tensor``, mean-reduced over the batch
by default (BigDL's ``sizeAverage``); gradients come from autograd.
Labels are 0-based integers (``one_based=True`` for Torch-style labels);
negative labels are padding and leave the loss.
"""

from __future__ import annotations

import torch

__all__ = ["Criterion", "ClassNLLCriterion", "CrossEntropyCriterion",
           "TimeDistributedCriterion"]


class Criterion:
    """Loss base (BigDL: nn/abstractnn/AbstractCriterion.scala)."""

    def __init__(self):
        self.output = None
        self.grad_input = None

    def loss(self, output, target):
        raise NotImplementedError

    def forward(self, output, target):
        self.output = self.loss(output, target)
        return self.output

    __call__ = forward

    def backward(self, output, target):
        """d loss / d output (AbstractCriterion.backward)."""
        out = output.detach().requires_grad_(True)
        with torch.enable_grad():
            (self.grad_input,) = torch.autograd.grad(self.loss(out, target),
                                                     out)
        return self.grad_input


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities (batch, classes) and
    integer labels (batch,) (nn/ClassNLLCriterion.scala), with optional
    per-class ``weights`` (weight-normalized mean) and ``label_smoothing``
    (mixes the one-hot target with the uniform distribution)."""

    def __init__(self, weights=None, size_average: bool = True,
                 one_based: bool = False, label_smoothing: float = 0.0):
        super().__init__()
        if not 0.0 <= label_smoothing < 1.0:
            raise ValueError(f"label_smoothing {label_smoothing}")
        if label_smoothing and weights is not None:
            raise ValueError("label_smoothing with per-class weights is "
                             "not supported")
        self.weights = None if weights is None else torch.as_tensor(weights)
        self.size_average = size_average
        self.one_based = one_based
        self.label_smoothing = label_smoothing

    def loss(self, output, target):
        return self.step_losses(output, torch.as_tensor(
            target, device=output.device).reshape(output.shape[:-1]))

    def step_losses(self, output, target):
        """The loss of each step of (batch, *steps, classes) output against
        (batch, *steps) labels, reduced over the batch axis only: shape
        ``steps``, each entry what :meth:`loss` gives that step's slice."""
        t = torch.as_tensor(target, device=output.device).long()
        if self.one_based:
            t = t - 1
        valid = t >= 0
        idx = t.clamp_min(0)
        picked = output.gather(-1, idx[..., None])[..., 0]
        count = valid.sum(0).clamp_min(1)
        if self.label_smoothing:
            eps = self.label_smoothing
            uniform = -output.mean(dim=-1)
            smoothed = torch.where(valid,
                                   (1 - eps) * (-picked) + eps * uniform,
                                   torch.zeros_like(picked))
            total = smoothed.sum(0)
            return total / count if self.size_average else total
        if self.weights is not None:
            w = self.weights.to(output.device)[idx] * valid
            total = -(w * picked).sum(0)
            return (total / w.sum(0).clamp_min(1e-12) if self.size_average
                    else total)
        masked = torch.where(valid, -picked, torch.zeros_like(picked))
        return masked.sum(0) / count if self.size_average else masked.sum(0)


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL over raw logits
    (nn/CrossEntropyCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True,
                 one_based: bool = False, label_smoothing: float = 0.0):
        super().__init__()
        self._nll = ClassNLLCriterion(weights, size_average, one_based,
                                      label_smoothing)

    def loss(self, output, target):
        return self._nll.loss(torch.log_softmax(output, dim=-1), target)

    def step_losses(self, output, target):
        return self._nll.step_losses(torch.log_softmax(output, dim=-1),
                                     target)


class TimeDistributedCriterion(Criterion):
    """Apply ``critrn`` at every time step of (batch, time, ...) output and
    sum, divided by T under ``size_average``
    (nn/TimeDistributedCriterion.scala; reference ``criterion.py:527``).
    Per-step means, not one mean over the flattened batch: the two differ
    when the padding labels vary from step to step.  The inner criterion
    gives every step's loss in one batched pass (``step_losses``, reducing
    over the batch axis only)."""

    def __init__(self, critrn: Criterion, size_average: bool = False):
        super().__init__()
        if not hasattr(critrn, "step_losses"):
            raise TypeError(f"TimeDistributedCriterion: "
                            f"{type(critrn).__name__} has no per-step "
                            f"losses (step_losses)")
        self.critrn = critrn
        self.size_average = size_average

    def loss(self, output, target):
        target = torch.as_tensor(target, device=output.device)
        total = self.critrn.step_losses(output, target).sum()
        return total / output.shape[1] if self.size_average else total
