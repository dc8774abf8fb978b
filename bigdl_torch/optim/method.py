"""Optimization methods: ``OptimMethod``, ``SGD``, ``Adam``, ``Adagrad``,
``Adadelta``, ``Adamax`` and ``RMSprop``.

Counterpart of ``bigdl_tpu/optim/method.py`` (reference
``optim/OptimMethod.scala:28``, ``optim/SGD.scala:38``, ``Adam.scala``,
``Adagrad.scala``, ``Adadelta.scala``, ``Adamax.scala``, ``RMSprop.scala``).
The reference's pure ``update(grads, params, state, lr) -> (params,
state)`` becomes an in-place update of the parameter tensors that returns
the new method state; the arithmetic is the reference's, term by term, as
``torch._foreach_*`` operations over all tensors at once.  A method's state
holds one list per slot (``velocity``, ``m``, ``v``, ...), in the order of
``model.parameters()``; ``utils/convert.py`` maps those lists to and from
the reference's param-shaped trees.  Host-side hyper-parameter logic (the
schedule, the driver's counters) stays outside the update and feeds it a
scalar ``lr`` each iteration.  ``LBFGS`` and ``EMA`` are not ported yet.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .schedules import Default

__all__ = ["OptimMethod", "SGD", "Adam", "Adagrad", "Adadelta", "Adamax",
           "RMSprop"]


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _apply(params, steps):
    """w -= step, each step cast to its parameter's dtype (the reference's
    ``w - step.astype(w.dtype)``)."""
    torch._foreach_sub_(params, [s.to(p.dtype) for s, p in zip(steps, params)])


def _count(t) -> np.int32:
    """An int32 step count (the reference keeps ``t`` as an int32 scalar)."""
    return np.int32(t)


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

    def optimize(self, feval, x):
        """One host-side step, the reference's ``optimize(feval, x)``
        (``OptimMethod.scala:38``): ``feval(x) -> (loss, grads)`` over a
        list of tensors ``x``, which is updated in place and returned with
        ``[loss]``.  The state stays on the instance, so repeated calls
        continue the trajectory."""
        loss, grads = feval(x)
        if not hasattr(self, "_opt_state"):
            self._opt_state = self.init_state(x)
        lr = self.get_learning_rate(self.hyper)
        self._opt_state = self.update(grads, x, self._opt_state, lr)
        self.hyper["evalCounter"] = self.hyper.get("evalCounter", 0) + 1
        return x, [float(loss)]

    def get_hyper_parameter(self):
        return {"learningRate": self.get_learning_rate()}

    def load_hyper(self, d):
        self.hyper.update(d)

    def state_dict(self):
        """The hyper-parameters and driver mirror as plain Python, and the
        host-side ``optimize`` trajectory (numpy leaves) where there is
        one: what the reference pickles into ``optimMethod.<n>``."""
        d = {"hyper": dict(self.hyper), "learning_rate": self.learning_rate}
        if hasattr(self, "_opt_state"):
            d["opt_state"] = {
                k: ([t.detach().cpu().numpy() for t in v]
                    if isinstance(v, list) else copy.deepcopy(v))
                for k, v in self._opt_state.items()}
        return d

    def load_state_dict(self, d):
        """Restore exactly the snapshot: live ``optimize`` state that the
        snapshot lacks is dropped."""
        self.hyper = dict(d["hyper"])
        self.learning_rate = d["learning_rate"]
        if "opt_state" in d:
            self._opt_state = {
                k: ([torch.as_tensor(np.asarray(t)) for t in v]
                    if isinstance(v, list) else copy.deepcopy(v))
                for k, v in d["opt_state"].items()}
        elif hasattr(self, "_opt_state"):
            del self._opt_state


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
            return {"velocity": _zeros(params)}
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
        _apply(params, torch._foreach_mul(grads, float(lr)))
        return state

    def get_learning_rate(self, driver_state=None):
        return self.schedule.get_lr(self, driver_state or self.hyper)


class _DecayedLR:
    """lr / (1 + neval · lrd), read from the driver's ``evalCounter``."""

    def get_learning_rate(self, driver_state=None):
        neval = (driver_state or self.hyper).get("evalCounter", 0)
        return self.learning_rate / (1 + neval * self.learning_rate_decay)


class Adam(_DecayedLR, OptimMethod):
    """Adam (reference: optim/Adam.scala; Torch semantics with bias
    correction): m = b1·m + (1 − b1)·g; v = b2·v + (1 − b2)·g²;
    w −= lr·sqrt(1 − b2^t) / (1 − b1^t) · m / (sqrt(v) + eps).  The step
    count ``t`` is an int32 and the bias corrections are float32, as in
    the reference."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.learning_rate_decay = learning_rate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params), "t": _count(0)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = _count(state["t"] + 1)
        m = torch._foreach_add(torch._foreach_mul(state["m"], b1),
                               torch._foreach_mul(grads, 1 - b1))
        v = torch._foreach_add(
            torch._foreach_mul(state["v"], b2),
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        f32 = np.float32
        tf = f32(t)
        bc1 = f32(1) - np.power(f32(b1), tf)
        bc2 = f32(1) - np.power(f32(b2), tf)
        step = f32(lr) * np.sqrt(bc2) / bc1
        denom = torch._foreach_add(torch._foreach_sqrt(v), eps)
        _apply(params, torch._foreach_div(
            torch._foreach_mul(m, float(step)), denom))
        return {"m": m, "v": v, "t": t}


class Adagrad(_DecayedLR, OptimMethod):
    """Adagrad (reference: optim/Adagrad.scala): g += wd·w; a += g²;
    w −= lr·g / (sqrt(a) + 1e-10)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, weight_decay: float = 0.0):
        super().__init__(learning_rate)
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def init_state(self, params):
        return {"accum": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        grads = list(grads)
        if self.weight_decay > 0:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(params, self.weight_decay))
        accum = torch._foreach_add(state["accum"],
                                   torch._foreach_mul(grads, grads))
        denom = torch._foreach_add(torch._foreach_sqrt(accum), 1e-10)
        _apply(params, torch._foreach_div(
            torch._foreach_mul(grads, float(lr)), denom))
        return {"accum": accum}


class Adadelta(OptimMethod):
    """Adadelta (reference: optim/Adadelta.scala): ag = rho·ag + (1 − rho)·g²;
    dx = g·sqrt(adx + eps) / sqrt(ag + eps); adx = rho·adx + (1 − rho)·dx²;
    w −= lr·dx, with lr a fixed 1.0."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        super().__init__(1.0)
        self.rho, self.epsilon = decay_rate, epsilon

    def init_state(self, params):
        return {"accum_g": _zeros(params), "accum_dx": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        rho, eps = self.rho, self.epsilon
        ag = torch._foreach_add(
            torch._foreach_mul(state["accum_g"], rho),
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - rho))
        dx = torch._foreach_div(
            torch._foreach_mul(grads, torch._foreach_sqrt(
                torch._foreach_add(state["accum_dx"], eps))),
            torch._foreach_sqrt(torch._foreach_add(ag, eps)))
        adx = torch._foreach_add(
            torch._foreach_mul(state["accum_dx"], rho),
            torch._foreach_mul(torch._foreach_mul(dx, dx), 1 - rho))
        _apply(params, torch._foreach_mul(dx, float(lr)))
        return {"accum_g": ag, "accum_dx": adx}


class Adamax(OptimMethod):
    """Adamax (reference: optim/Adamax.scala): m = b1·m + (1 − b1)·g;
    u = max(b2·u, |g| + eps); w −= lr / (1 − b1^t) · m / u, the bias
    correction float32 from an int32 ``t``."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params), "t": _count(0)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        b1, b2 = self.beta1, self.beta2
        t = _count(state["t"] + 1)
        m = torch._foreach_add(torch._foreach_mul(state["m"], b1),
                               torch._foreach_mul(grads, 1 - b1))
        u = torch._foreach_maximum(
            torch._foreach_mul(state["u"], b2),
            torch._foreach_add(torch._foreach_abs(grads), self.epsilon))
        f32 = np.float32
        bc = f32(1) - np.power(f32(b1), f32(t))
        scale = f32(lr) / bc
        _apply(params, torch._foreach_div(
            torch._foreach_mul(m, float(scale)), u))
        return {"m": m, "u": u, "t": t}


class RMSprop(_DecayedLR, OptimMethod):
    """RMSprop (reference: optim/RMSprop.scala): r = rho·r + (1 − rho)·g²;
    w −= lr·g / (sqrt(r) + eps)."""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0, decay_rate: float = 0.99,
                 epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.learning_rate_decay = learning_rate_decay
        self.rho, self.epsilon = decay_rate, epsilon

    def init_state(self, params):
        return {"rms": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        rms = torch._foreach_add(
            torch._foreach_mul(state["rms"], self.rho),
            torch._foreach_mul(torch._foreach_mul(grads, grads),
                               1 - self.rho))
        denom = torch._foreach_add(torch._foreach_sqrt(rms), self.epsilon)
        _apply(params, torch._foreach_div(
            torch._foreach_mul(grads, float(lr)), denom))
        return {"rms": rms}
