"""Weight regularizers: ``L1L2Regularizer``, ``L1Regularizer``,
``L2Regularizer`` and ``apply_regularizer_grads``.

Counterpart of ``bigdl_tpu/optim/regularizer.py`` (reference
``optim/Regularizer.scala:30,87,175,186``, applied inside each layer's
accGradParameters).  A regularizer contributes ``grad(w)`` terms that the
Optimizer adds to the autograd gradients before the wire cast, at the
layers that name one: ``w_regularizer`` / ``b_regularizer`` constructor
arguments of ``SpatialConvolution`` and ``Linear``, ``w_regularizer`` of
``LookupTable``.
"""

from __future__ import annotations

import torch

__all__ = ["Regularizer", "L1Regularizer", "L2Regularizer",
           "L1L2Regularizer", "apply_regularizer_grads"]


class Regularizer:
    def grad(self, w):
        raise NotImplementedError

    def loss(self, w):
        raise NotImplementedError


class L1L2Regularizer(Regularizer):
    """l1 · sign(w) + l2 · w (optim/Regularizer.scala:87)."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1, self.l2 = l1, l2

    def grad(self, w):
        g = 0.0
        if self.l1:
            g = g + self.l1 * torch.sign(w)
        if self.l2:
            g = g + self.l2 * w
        return g

    def loss(self, w):
        out = 0.0
        if self.l1:
            out = out + self.l1 * torch.sum(torch.abs(w))
        if self.l2:
            out = out + 0.5 * self.l2 * torch.sum(torch.square(w))
        return out


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2: float):
        super().__init__(l2=l2)


@torch.no_grad()
def apply_regularizer_grads(model, params, grads, values=None):
    """``grads`` (a list aligned with ``params``, the model's parameters
    in order) with every layer's regularizer gradient added: its
    ``w_regularizer`` at its ``weight``, its ``b_regularizer`` at its
    ``bias`` (the reference's accGradParameters placement), taken at
    ``values`` (default ``params``; under ZeRO the views of this rank's
    slices, which ``grads`` then holds).  Returns a new list; the tensors
    of unregularized parameters pass through."""
    index = {id(p): i for i, p in enumerate(params)}
    values = params if values is None else values
    out = list(grads)
    for m in model.modules():
        names = getattr(m, "param_names", ())
        for attr, name in (("w_regularizer", "weight"),
                           ("b_regularizer", "bias")):
            reg = getattr(m, attr, None)
            if reg is None or name not in names:
                continue
            i = index[id(getattr(m, name))]
            out[i] = out[i] + reg.grad(values[i])
    return out
