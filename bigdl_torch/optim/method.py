"""Optimization methods: ``OptimMethod`` and ``SGD``.

Counterpart of ``bigdl_tpu/optim/method.py`` for what the training slice
uses (reference ``optim/OptimMethod.scala:28``, ``optim/SGD.scala:38``).
The reference's pure ``update(grads, params, state, lr) -> (params,
state)`` becomes an in-place update of the parameter tensors that returns
the new method state; the arithmetic is the reference's, term by term, as
``torch._foreach_*`` operations over all tensors at once.  Host-side
hyper-parameter logic (the schedule, the driver's counters) stays outside
the update and feeds it a scalar ``lr`` each iteration.
"""

from __future__ import annotations

import torch

from .schedules import Default

__all__ = ["OptimMethod", "SGD"]


class OptimMethod:
    """Base optimizer (reference: optim/OptimMethod.scala:28)."""

    def __init__(self, learning_rate: float = 1e-3):
        self.learning_rate = learning_rate
        # host-side mirror of the driver state (the reference's state Table)
        self.hyper = {"evalCounter": 0, "epoch": 1}

    def init_state(self, params):
        return {}

    def update(self, grads, params, state, lr):
        """Update ``params`` (a list of tensors) in place from ``grads``;
        returns the new method state."""
        raise NotImplementedError

    def get_learning_rate(self, driver_state=None) -> float:
        return self.learning_rate


class SGD(OptimMethod):
    """SGD with weight decay, momentum, dampening and nesterov, Torch's
    semantics: g += wd·w; v = mu·v + (1 − damp)·g; g = g + mu·v (nesterov)
    or v; w −= clr·g, with clr from the schedule (Default:
    lr / (1 + neval·lrd)).  The velocity starts at zero."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: float = None, nesterov: bool = False,
                 learning_rate_schedule=None):
        super().__init__(learning_rate)
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov requires momentum > 0 and dampening = 0 (SGD.scala)")
        self.schedule = learning_rate_schedule or Default()

    def init_state(self, params):
        if self.momentum > 0:
            return {"velocity": [torch.zeros_like(p) for p in params]}
        return {}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        wd, mu, damp = self.weight_decay, self.momentum, self.dampening
        grads = list(grads)
        if wd > 0:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        if mu > 0:
            vel = torch._foreach_add(
                torch._foreach_mul(state["velocity"], mu),
                torch._foreach_mul(grads, 1 - damp))
            grads = (torch._foreach_add(grads, torch._foreach_mul(vel, mu))
                     if self.nesterov else vel)
            state = {"velocity": vel}
        steps = torch._foreach_mul(
            [g.to(p.dtype) for g, p in zip(grads, params)], float(lr))
        torch._foreach_sub_(params, steps)
        return state

    def get_learning_rate(self, driver_state=None):
        return self.schedule.get_lr(self, driver_state or self.hyper)
