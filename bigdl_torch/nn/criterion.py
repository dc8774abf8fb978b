"""Loss functions: BigDL's 26 criteria (one file each under ``nn/``).

Counterpart of ``bigdl_tpu/nn/criterion.py`` (and its ``Criterion`` base
in ``nn/module.py``).  A criterion's core is ``loss(output, target) ->
scalar tensor``, mean-reduced by default (BigDL's ``sizeAverage``, the
reference's ``_reduce``); gradients come from autograd.  Labels are
0-based integers (``one_based=True`` where offered for Torch-style
labels); ``ClassNLLCriterion`` treats negative labels as padding.
``MultiCriterion`` and ``ParallelCriterion`` hold the port's criteria.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .activation import softplus
from .math_ops import unit_rows

__all__ = [
    "Criterion", "AbsCriterion", "BCECriterion", "ClassNLLCriterion",
    "ClassSimplexCriterion", "CosineDistanceCriterion",
    "CosineEmbeddingCriterion", "CrossEntropyCriterion",
    "DiceCoefficientCriterion", "DistKLDivCriterion",
    "HingeEmbeddingCriterion", "L1Cost", "L1HingeEmbeddingCriterion",
    "L1Penalty", "MarginCriterion", "MarginRankingCriterion",
    "MSECriterion", "MultiCriterion", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion",
    "ParallelCriterion", "SmoothL1Criterion",
    "SmoothL1CriterionWithWeights", "SoftMarginCriterion",
    "SoftmaxWithCriterion", "TimeDistributedCriterion",
]


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


def _reduce(x, size_average: bool):
    return x.mean() if size_average else x.sum()


def _like(v, ref: torch.Tensor):
    """A target, weight or scalar as a tensor on ``ref``'s device."""
    if isinstance(v, torch.Tensor):
        return v.to(ref.device)
    return torch.as_tensor(np.asarray(v), device=ref.device)


def _labels(target, ref, one_based: bool):
    t = _like(target, ref).long().reshape(-1)
    return t - 1 if one_based else t


class _PerStep(Criterion):
    """A criterion on tensors, given per-step losses for
    :class:`TimeDistributedCriterion`: one call of ``loss`` for each step
    of the time axis (axis 1)."""

    def step_losses(self, output, target):
        target = _like(target, output)
        return torch.stack([self.loss(output[:, t], target[:, t])
                            for t in range(output.shape[1])])


class AbsCriterion(_PerStep):
    """mean |x - y| (nn/AbsCriterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        return _reduce((output - _like(target, output)).abs(),
                       self.size_average)


class MSECriterion(_PerStep):
    """mean (x - y)^2 (nn/MSECriterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        return _reduce((output - _like(target, output)).square(),
                       self.size_average)


class BCECriterion(_PerStep):
    """Binary cross-entropy on probabilities, with optional per-element
    weights (nn/BCECriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = weights
        self.size_average = size_average

    def loss(self, output, target):
        eps = 1e-12
        t = _like(target, output)
        o = output.clamp(eps, 1.0 - eps)
        ls = -(t * torch.log(o) + (1.0 - t) * torch.log1p(-o))
        if self.weights is not None:
            ls = ls * _like(self.weights, output)
        return _reduce(ls, self.size_average)


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


class ClassSimplexCriterion(_PerStep):
    """MSE against a regular-simplex embedding of the labels
    (nn/ClassSimplexCriterion.scala)."""

    def __init__(self, n_classes: int, size_average: bool = True,
                 one_based: bool = False):
        super().__init__()
        self.n_classes = n_classes
        self.size_average = size_average
        self.one_based = one_based
        eye = np.eye(n_classes, dtype=np.float32)
        centered = eye - eye.mean(axis=0, keepdims=True)
        self.simplex = torch.from_numpy(
            centered / np.linalg.norm(centered, axis=1, keepdims=True))

    def loss(self, output, target):
        t = _labels(target, output, self.one_based)
        goal = self.simplex.to(output.device)[t]
        return _reduce((output - goal).square(), self.size_average)


class CosineDistanceCriterion(_PerStep):
    """1 - cos(x, y) per row (nn/CosineDistanceCriterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        cos = (unit_rows(output) * unit_rows(_like(target, output))).sum(-1)
        return _reduce(1.0 - cos, self.size_average)


class CosineEmbeddingCriterion(Criterion):
    """Input [x1, x2], target +-1 (nn/CosineEmbeddingCriterion.scala):
    1 - cos for +1, max(0, cos - margin) for -1."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def loss(self, output, target):
        x1, x2 = output[0], output[1]
        cos = (x1 * x2).sum(-1) / (
            torch.linalg.vector_norm(x1, dim=-1) *
            torch.linalg.vector_norm(x2, dim=-1) + 1e-12)
        t = _like(target, cos).reshape(cos.shape)
        ls = torch.where(t > 0, 1.0 - cos, (cos - self.margin).clamp_min(0))
        return _reduce(ls, self.size_average)


class DiceCoefficientCriterion(_PerStep):
    """1 - the dice overlap of each row (nn/DiceCoefficientCriterion.scala)."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__()
        self.size_average = size_average
        self.epsilon = epsilon

    def loss(self, output, target):
        o = output.reshape(output.shape[0], -1)
        t = _like(target, output).reshape(o.shape[0], -1)
        inter = (o * t).sum(1)
        denom = o.sum(1) + t.sum(1)
        dice = (2.0 * inter + self.epsilon) / (denom + self.epsilon)
        return _reduce(1.0 - dice, self.size_average)


class DistKLDivCriterion(_PerStep):
    """KL(target || exp(output)) over log-probabilities: target *
    (log target - output), divided by the batch under ``size_average``
    (nn/DistKLDivCriterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        t = _like(target, output)
        ls = torch.where(t > 0, t * (torch.log(t.clamp_min(1e-12)) - output),
                         torch.zeros((), dtype=output.dtype,
                                     device=output.device))
        total = ls.sum()
        return total / output.shape[0] if self.size_average else total


class HingeEmbeddingCriterion(_PerStep):
    """x where y = 1, max(0, margin - x) elsewhere
    (nn/HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def loss(self, output, target):
        ls = torch.where(_like(target, output) > 0, output,
                         (self.margin - output).clamp_min(0))
        return _reduce(ls, self.size_average)


class L1Cost(_PerStep):
    """sum |x| (nn/L1Cost.scala); the target is ignored."""

    def loss(self, output, target=None):
        return output.abs().sum()


class L1HingeEmbeddingCriterion(Criterion):
    """The L1 distance of a pair [x1, x2] for target +1, max(0, margin -
    distance) for -1, averaged (nn/L1HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = margin

    def loss(self, output, target):
        d = (output[0] - output[1]).abs().sum(-1)
        t = _like(target, d).reshape(d.shape)
        return torch.where(t > 0, d, (self.margin - d).clamp_min(0)).mean()


class L1Penalty(_PerStep):
    """l1weight * the reduced |x| (nn/L1Penalty.scala)."""

    def __init__(self, l1weight: float = 1.0, size_average: bool = False,
                 provide_output: bool = True):
        super().__init__()
        self.l1weight = l1weight
        self.size_average = size_average

    def loss(self, output, target=None):
        return self.l1weight * _reduce(output.abs(), self.size_average)


class MarginCriterion(_PerStep):
    """Hinge max(0, margin - y x) (nn/MarginCriterion.scala); squared, the
    L2-SVM loss."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        super().__init__()
        self.margin = margin
        self.size_average = size_average
        self.squared = squared

    def loss(self, output, target):
        ls = (self.margin - _like(target, output) * output).clamp_min(0)
        if self.squared:
            ls = ls.square()
        return _reduce(ls, self.size_average)


class MarginRankingCriterion(Criterion):
    """max(0, -y (x1 - x2) + margin) on input [x1, x2]
    (nn/MarginRankingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def loss(self, output, target):
        d = output[0] - output[1]
        t = _like(target, d)
        if t.dim():
            t = t.reshape(d.shape)
        return _reduce((-t * d + self.margin).clamp_min(0),
                       self.size_average)


class MultiCriterion(_PerStep):
    """A weighted sum of criteria on the same (output, target)
    (nn/MultiCriterion.scala)."""

    def __init__(self):
        super().__init__()
        self.criterions = []
        self.weights = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def loss(self, output, target):
        return sum(w * c.loss(output, target)
                   for c, w in zip(self.criterions, self.weights))


class ParallelCriterion(Criterion):
    """A weighted sum of criteria, the i-th on the i-th (output, target)
    pair, or on the one target under ``repeat_target``
    (nn/ParallelCriterion.scala)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.criterions = []
        self.weights = []
        self.repeat_target = repeat_target

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def loss(self, output, target):
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.weights)):
            t = target if self.repeat_target else target[i]
            total = total + w * c.loss(output[i], t)
        return total


class MultiLabelMarginCriterion(_PerStep):
    """Multi-class multi-label hinge (nn/MultiLabelMarginCriterion.scala).
    Target (batch, n): 0-based label indices padded with -1 (with
    ``one_based``, 1-based padded with 0)."""

    def __init__(self, size_average: bool = True, one_based: bool = False):
        super().__init__()
        self.size_average = size_average
        self.one_based = one_based

    def loss(self, output, target):
        t = _like(target, output).long()
        if self.one_based:
            t = t - 1
        n = output.shape[-1]
        valid = t >= 0
        t_safe = t.clamp_min(0)
        # a max, not a plain scatter: every padding slot lands on class 0
        # and must not clear a real class 0 (CUDA scatters no bools)
        is_target = torch.zeros_like(output).scatter_reduce_(
            1, t_safe, valid.to(output.dtype), "amax") > 0
        tgt = output.gather(1, t_safe)
        # the hinge of every non-target against every valid target
        margins = 1.0 - tgt[:, :, None] + output[:, None, :]
        mask = valid[:, :, None] & ~is_target[:, None, :]
        ls = torch.where(mask, margins.clamp_min(0),
                         torch.zeros((), dtype=output.dtype,
                                     device=output.device)).sum((1, 2)) / n
        return _reduce(ls, self.size_average)


class MultiLabelSoftMarginCriterion(_PerStep):
    """Sigmoid and BCE per class over raw scores
    (nn/MultiLabelSoftMarginCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = weights
        self.size_average = size_average

    def loss(self, output, target):
        t = _like(target, output)
        ls = softplus(-output) * t + softplus(output) * (1.0 - t)
        if self.weights is not None:
            ls = ls * _like(self.weights, output)
        return _reduce(ls.mean(-1), self.size_average)


class MultiMarginCriterion(_PerStep):
    """Multi-class hinge (nn/MultiMarginCriterion.scala)."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True, one_based: bool = False):
        super().__init__()
        self.p, self.weights, self.margin = p, weights, margin
        self.size_average = size_average
        self.one_based = one_based

    def loss(self, output, target):
        t = _labels(target, output, self.one_based)
        n = output.shape[-1]
        tgt = output.gather(1, t[:, None])
        m = (self.margin - tgt + output).clamp_min(0) ** self.p
        if self.weights is not None:
            m = m * _like(self.weights, output)[t][:, None]
        onehot = F.one_hot(t, n).bool()
        ls = torch.where(onehot, torch.zeros((), dtype=m.dtype,
                                             device=m.device), m).sum(-1) / n
        return _reduce(ls, self.size_average)


class SmoothL1Criterion(_PerStep):
    """Huber loss with delta 1 (nn/SmoothL1Criterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        d = (output - _like(target, output)).abs()
        return _reduce(torch.where(d < 1.0, 0.5 * d.square(), d - 0.5),
                       self.size_average)


class SmoothL1CriterionWithWeights(Criterion):
    """Smooth L1 with inside and outside weights and sigma, as Fast-RCNN
    uses it (nn/SmoothL1CriterionWithWeights.scala); the target is
    [t, inside_w, outside_w], the weights optional."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__()
        self.sigma2 = sigma * sigma
        self.num = num

    def loss(self, output, target):
        if isinstance(target, (list, tuple)):
            t = _like(target[0], output)
            in_w = _like(target[1], output) if len(target) > 1 else 1.0
            out_w = _like(target[2], output) if len(target) > 2 else 1.0
        else:
            t, in_w, out_w = _like(target, output), 1.0, 1.0
        d = in_w * (output - t)
        ad = d.abs()
        ls = torch.where(ad < 1.0 / self.sigma2,
                         0.5 * self.sigma2 * d.square(),
                         ad - 0.5 / self.sigma2)
        total = (out_w * ls).sum()
        return total / self.num if self.num > 0 else total


class SoftMarginCriterion(_PerStep):
    """log(1 + e^(-y x)) (nn/SoftMarginCriterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        return _reduce(softplus(-_like(target, output) * output),
                       self.size_average)


class SoftmaxWithCriterion(_PerStep):
    """Caffe's SoftmaxWithLoss over NHWC maps
    (nn/SoftmaxWithCriterion.scala): per-pixel cross-entropy with an
    optional ``ignore_label``; ``normalize_mode`` one of 'valid',
    'batch_size', 'full', 'none'."""

    def __init__(self, ignore_label: int = None, normalize_mode: str = "valid",
                 one_based: bool = False):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode
        self.one_based = one_based

    def loss(self, output, target):
        logp = torch.log_softmax(output, dim=-1)
        t = _like(target, output).long()
        if self.one_based:
            t = t - 1
        valid = torch.ones_like(t, dtype=torch.bool) \
            if self.ignore_label is None \
            else t != (self.ignore_label - (1 if self.one_based else 0))
        t_safe = torch.where(valid, t, torch.zeros_like(t))
        picked = logp.gather(-1, t_safe[..., None])[..., 0]
        total = -torch.where(valid, picked, torch.zeros_like(picked)).sum()
        if self.normalize_mode == "valid":
            return total / valid.sum().clamp_min(1)
        if self.normalize_mode == "batch_size":
            return total / output.shape[0]
        if self.normalize_mode == "full":
            return total / t.numel()
        return total


class TimeDistributedCriterion(Criterion):
    """Apply ``critrn`` at every time step of (batch, time, ...) output and
    sum, divided by T under ``size_average``
    (nn/TimeDistributedCriterion.scala; reference ``criterion.py:527``).
    Per-step means, not one mean over the flattened batch: the two differ
    when the padding labels vary from step to step.  The inner criterion
    gives every step's loss (``step_losses``): ``ClassNLLCriterion`` and
    ``CrossEntropyCriterion`` in one batched pass reducing over the batch
    axis only, the other criteria on tensors one call a step."""

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
