"""Validation metrics.

Counterpart of ``bigdl_tpu/optim/validation.py`` (reference
``optim/ValidationMethod.scala:34``: metric objects producing
``ValidationResult`` objects that aggregate with ``+``: ``Top1Accuracy``
(:170), ``Top5Accuracy`` (:218), ``Loss`` (:312), ``MAE`` (:332),
``TreeNNAccuracy`` (:118); ``Perplexity``, ``HitRatio`` and ``NDCG`` are
the reference's additions).  Like the reference, every method scores host
numpy arrays: the output rows of one batch, cut to its valid rows, against
their targets.  ``Loss`` runs the port's criterion on CPU float32 tensors
made from them.  Every result is a flat struct of numbers, so results from
several ranks sum field by field (``Optimizer`` does that in one
all-reduce).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ValidationResult", "AccuracyResult", "LossResult",
           "Perplexity", "PerplexityResult",
           "ValidationMethod", "Top1Accuracy", "Top5Accuracy", "Loss", "MAE",
           "HitRatio", "NDCG", "TreeNNAccuracy"]


class ValidationResult:
    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    """(correct, count) pair (ValidationMethod.scala:52)."""

    def __init__(self, correct: float, count: int):
        self.correct, self.count = correct, count

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        acc, n = self.result()
        return f"Accuracy(correct: {self.correct}, count: {n}, accuracy: {acc})"


class LossResult(ValidationResult):
    def __init__(self, loss: float, count: int):
        self.loss, self.count = loss, count

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        l, n = self.result()
        return f"Loss(loss: {self.loss}, count: {n}, average: {l})"


class ValidationMethod:
    """Metric over one (output, target) minibatch -> ValidationResult."""

    name = "ValidationMethod"

    def __call__(self, output, target) -> ValidationResult:
        raise NotImplementedError

    def __repr__(self):
        return self.name


class Top1Accuracy(ValidationMethod):
    """argmax == label (ValidationMethod.scala:170). 0-based labels."""

    name = "Top1Accuracy"

    def __init__(self, one_based: bool = False):
        self.one_based = one_based

    def __call__(self, output, target):
        o = np.asarray(output)
        t = np.asarray(target).reshape(-1).astype(np.int64)
        if self.one_based:
            t = t - 1
        pred = np.argmax(o.reshape(t.shape[0], -1), axis=-1)
        return AccuracyResult(float(np.sum(pred == t)), t.shape[0])


class Top5Accuracy(ValidationMethod):
    """label in top-5 (ValidationMethod.scala:218)."""

    name = "Top5Accuracy"

    def __init__(self, one_based: bool = False):
        self.one_based = one_based

    def __call__(self, output, target):
        o = np.asarray(output)
        t = np.asarray(target).reshape(-1).astype(np.int64)
        if self.one_based:
            t = t - 1
        o = o.reshape(t.shape[0], -1)
        top5 = np.argsort(-o, axis=-1)[:, :5]
        hit = np.any(top5 == t[:, None], axis=-1)
        return AccuracyResult(float(np.sum(hit)), t.shape[0])


class Loss(ValidationMethod):
    """Criterion value as a metric (ValidationMethod.scala:312)."""

    name = "Loss"

    def __init__(self, criterion=None):
        if criterion is None:
            from ..nn.criterion import ClassNLLCriterion
            criterion = ClassNLLCriterion()
        self.criterion = criterion

    def __call__(self, output, target):
        out = torch.as_tensor(np.asarray(output, np.float32))
        tgt = torch.as_tensor(np.asarray(target))
        with torch.no_grad():
            loss = float(self.criterion.loss(out, tgt))
        n = int(np.asarray(target).shape[0])
        return LossResult(loss * n, n)


class PerplexityResult(ValidationResult):
    """Aggregates total token NLL + token count; result() = exp(mean)."""

    def __init__(self, nll: float, count: int):
        self.nll, self.count = nll, count

    def result(self):
        # np.exp: overflows to inf (a diverged model or raw-logit misuse
        # must report ppl=inf, not crash the validation logging)
        return (float(np.exp(self.nll / max(self.count, 1))), self.count)

    def __add__(self, other):
        return PerplexityResult(self.nll + other.nll,
                                self.count + other.count)

    def __repr__(self):
        p, n = self.result()
        return f"Perplexity(ppl: {p:.4f}, tokens: {n})"


class Perplexity(ValidationMethod):
    """exp(mean per-token NLL) over [B, T, vocab] log-prob outputs and
    [B, T] integer targets — the LM metric (net-new vs the 2017 reference,
    whose only sequence metric is per-batch Loss; pairs with TransformerLM
    / SimpleRNN outputs which end in LogSoftMax).  Negative targets are
    padding and excluded from both the NLL sum and the token count."""

    name = "Perplexity"

    def __call__(self, output, target):
        o = np.asarray(output, np.float64)
        t = np.asarray(target).astype(np.int64)
        o2 = o.reshape(-1, o.shape[-1])
        t2 = t.reshape(-1)
        valid = t2 >= 0
        picked = o2[np.arange(t2.shape[0]), np.maximum(t2, 0)]
        nll = float(-np.sum(picked[valid]))
        return PerplexityResult(nll, int(valid.sum()))


class MAE(ValidationMethod):
    """Mean absolute error between argmax-decoded output and target
    (ValidationMethod.scala:332)."""

    name = "MAE"

    def __call__(self, output, target):
        o = np.asarray(output)
        t = np.asarray(target).reshape(-1)
        pred = np.argmax(o.reshape(t.shape[0], -1), axis=-1).astype(np.float64)
        return LossResult(float(np.sum(np.abs(pred - t))), t.shape[0])


class HitRatio(ValidationMethod):
    """HR@k for recommendation (later-BigDL parity; simple extra)."""

    name = "HitRatio"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k

    def __call__(self, output, target):
        o = np.asarray(output).reshape(-1)
        t = np.asarray(target).reshape(-1)
        pos = o[t > 0.5]
        rank = np.sum(o[None, :] > pos[:, None], axis=-1) + 1
        hit = np.sum(rank <= self.k)
        return AccuracyResult(float(hit), pos.shape[0])


class NDCG(ValidationMethod):
    name = "NDCG"

    def __init__(self, k: int = 10):
        self.k = k

    def __call__(self, output, target):
        o = np.asarray(output).reshape(-1)
        t = np.asarray(target).reshape(-1)
        pos = o[t > 0.5]
        rank = np.sum(o[None, :] > pos[:, None], axis=-1) + 1
        gain = np.where(rank <= self.k, 1.0 / np.log2(rank + 1), 0.0)
        return AccuracyResult(float(np.sum(gain)), pos.shape[0])


class TreeNNAccuracy(ValidationMethod):
    """Accuracy read at the tree ROOT node's prediction
    (reference: ValidationMethod.scala:118 TreeNNAccuracy reads a FIXED
    slot; output is the per-node (batch, nodes, classes) array of a tree
    model's head).  Here the fixed slot is the LAST one, where the
    reference's tree encoding places the root, padding smaller trees
    before it.  For layouts that don't follow it, pass per-example
    `root_slot` indices."""

    name = "TreeNNAccuracy"

    def __init__(self, one_based: bool = False):
        self.one_based = one_based

    def __call__(self, output, target, root_slot=None):
        o = np.asarray(output)
        t = np.asarray(target)
        if root_slot is not None:
            rs = np.asarray(root_slot).reshape(-1).astype(np.int64)
        else:
            rs = None
        if t.ndim >= 2 and t.shape[1] > 1:  # per-node labels: take the root
            t = t[np.arange(len(t)), rs] if rs is not None else t[:, -1]
        t = t.reshape(len(o)).astype(np.int64)
        if self.one_based:
            t = t - 1
        if o.ndim == 3:
            root = o[np.arange(len(o)), rs, :] if rs is not None else o[:, -1, :]
        else:
            root = o
        pred = np.argmax(root, axis=-1)
        return AccuracyResult(float(np.sum(pred == t)), len(t))
