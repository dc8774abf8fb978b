"""Learning-rate schedules.

Counterpart of ``bigdl_tpu/optim/schedules.py``, nearly line for line
(reference: the ``LearningRateSchedule`` family inside BigDL
``optim/SGD.scala:203``: ``EpochSchedule`` (:224), ``Poly`` (:281),
``Step`` (:316), ``MultiStep`` (:349), ``EpochDecay`` (:385),
``EpochStep`` (:412), ``NaturalExp`` (:446), ``Exponential`` (:467),
``Default`` (:491), ``Plateau`` (:534), with ``Regime`` (:516) as the
epoch-range config holder; ``CosineDecay``, ``Warmup`` and
``SequentialSchedule`` are the reference's additions).

A schedule runs on the host each iteration and feeds the update a scalar
``lr``: ``get_lr(optim, state) -> float``, with ``state`` the driver's dict
(``evalCounter`` the 0-based iteration, ``epoch``, and ``score`` or
``loss`` where validation has written them).
"""

from __future__ import annotations

__all__ = ["LearningRateSchedule", "Default", "Poly", "Step", "MultiStep",
           "EpochDecay", "EpochStep", "NaturalExp", "Exponential",
           "EpochSchedule", "Regime", "Plateau", "SequentialSchedule",
           "Warmup", "CosineDecay"]

import math


class LearningRateSchedule:
    def get_lr(self, optim, state) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """clr = lr / (1 + neval * lrd) (SGD.scala:491)."""

    def get_lr(self, optim, state):
        neval = state.get("evalCounter", 0)
        lrd = getattr(optim, "learning_rate_decay", 0.0)
        return optim.learning_rate / (1 + neval * lrd)


class Poly(LearningRateSchedule):
    """lr * (1 - iter/maxIter)^power (SGD.scala:281)."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def get_lr(self, optim, state):
        neval = min(state.get("evalCounter", 0), self.max_iteration)
        return optim.learning_rate * (1.0 - neval / self.max_iteration) ** self.power


class Step(LearningRateSchedule):
    """lr * gamma^floor(iter/stepSize) (SGD.scala:316)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def get_lr(self, optim, state):
        neval = state.get("evalCounter", 0)
        return optim.learning_rate * self.gamma ** (neval // self.step_size)


class MultiStep(LearningRateSchedule):
    """lr * gamma^(#milestones passed) (SGD.scala:349)."""

    def __init__(self, step_sizes, gamma: float):
        self.step_sizes, self.gamma = list(step_sizes), gamma

    def get_lr(self, optim, state):
        neval = state.get("evalCounter", 0)
        k = sum(1 for s in self.step_sizes if neval >= s)
        return optim.learning_rate * self.gamma ** k


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch) (SGD.scala:385)."""

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def get_lr(self, optim, state):
        return optim.learning_rate * (0.1 ** self.decay_fn(state.get("epoch", 1)))


class EpochStep(LearningRateSchedule):
    """lr * gamma^floor((epoch-1)/stepSize) (SGD.scala:412)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def get_lr(self, optim, state):
        epoch = state.get("epoch", 1)
        return optim.learning_rate * self.gamma ** ((epoch - 1) // self.step_size)


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(iter/decayStep)) (SGD.scala:446)."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step, self.gamma = decay_step, gamma

    def get_lr(self, optim, state):
        neval = state.get("evalCounter", 0)
        return optim.learning_rate * math.exp(-self.gamma *
                                              (neval // self.decay_step))


class Exponential(LearningRateSchedule):
    """lr * gamma^(iter/decayStep), optionally staircased (SGD.scala:467)."""

    def __init__(self, decay_step: int, decay_rate: float, stair_case: bool = False):
        self.decay_step, self.decay_rate, self.stair_case = \
            decay_step, decay_rate, stair_case

    def get_lr(self, optim, state):
        neval = state.get("evalCounter", 0)
        p = neval / self.decay_step
        if self.stair_case:
            p = math.floor(p)
        return optim.learning_rate * self.decay_rate ** p


class Regime:
    """Epoch-range hyper-parameter block (SGD.scala:516)."""

    def __init__(self, start_epoch: int, end_epoch: int, config: dict):
        self.start_epoch, self.end_epoch, self.config = \
            start_epoch, end_epoch, config


class EpochSchedule(LearningRateSchedule):
    """Piecewise-per-epoch regime table (SGD.scala:224)."""

    def __init__(self, regimes):
        self.regimes = list(regimes)

    def get_lr(self, optim, state):
        epoch = state.get("epoch", 1)
        lr = optim.learning_rate
        for r in self.regimes:
            if r.start_epoch <= epoch <= r.end_epoch:
                lr = r.config.get("learningRate", lr)
                # side effects for other hypers, mirroring the reference
                if "weightDecay" in r.config and hasattr(optim, "weight_decay"):
                    optim.weight_decay = r.config["weightDecay"]
        return lr


class Plateau(LearningRateSchedule):
    """Reduce-on-plateau (SGD.scala:534): monitor 'score' (or 'loss'), scale lr
    by `factor` after `patience` non-improving epochs."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon, self.cooldown_len = mode, epsilon, cooldown
        self.min_lr = min_lr
        self.best = None
        self.wait = 0
        self.cooldown = 0
        self.current_lr = None

    def _improved(self, value):
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.epsilon
        return value > self.best + self.epsilon

    def get_lr(self, optim, state):
        if self.current_lr is None:
            self.current_lr = optim.learning_rate
        value = state.get(self.monitor)
        if value is not None and state.get("_plateau_seen") != state.get("epoch"):
            state["_plateau_seen"] = state.get("epoch")
            if self.cooldown > 0:
                self.cooldown -= 1
                self.wait = 0
            if self._improved(value):
                self.best = value
                self.wait = 0
            elif self.cooldown <= 0:
                self.wait += 1
                if self.wait >= self.patience:
                    self.current_lr = max(self.current_lr * self.factor,
                                          self.min_lr)
                    self.cooldown = self.cooldown_len
                    self.wait = 0
        return self.current_lr


class CosineDecay(LearningRateSchedule):
    """lr * (min_factor + (1-min_factor) * 0.5*(1+cos(pi * t/T))) over T
    iterations, then held at lr*min_factor (not in the 2017 reference —
    the standard modern schedule for long training runs; pairs with Warmup
    via `Warmup(delta, n, after=CosineDecay(T))`)."""

    def __init__(self, max_iteration: int, min_factor: float = 0.0):
        if max_iteration <= 0:
            raise ValueError(f"max_iteration {max_iteration}")
        self.max_iteration = max_iteration
        self.min_factor = min_factor

    def get_lr(self, optim, state):
        t = min(state.get("evalCounter", 0), self.max_iteration)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / self.max_iteration))
        return optim.learning_rate * (self.min_factor
                                      + (1.0 - self.min_factor) * cos)


class _PeakLR:
    """Proxy presenting the warmup PEAK as `learning_rate` to the
    after-schedule while passing every other attribute through — including
    WRITES (EpochSchedule's regime side effects must land on the real
    optimizer, not a throwaway proxy)."""

    def __init__(self, optim, peak):
        object.__setattr__(self, "_optim", optim)
        object.__setattr__(self, "learning_rate", peak)

    def __getattr__(self, name):
        return getattr(self._optim, name)

    def __setattr__(self, name, value):
        setattr(self._optim, name, value)


class _ShiftedState:
    """Dict-like view of the driver state with a rebased evalCounter.
    Reads of every OTHER key and ALL writes pass through to the real
    state dict, so stateful schedules (Plateau's once-per-epoch marker)
    keep working under Warmup/SequentialSchedule re-basing — a plain
    dict copy would silently discard their bookkeeping."""

    def __init__(self, base, eval_counter):
        self._base = base
        self._counter = eval_counter

    def get(self, key, default=None):
        if key == "evalCounter":
            return self._counter
        return self._base.get(key, default)

    def __getitem__(self, key):
        if key == "evalCounter":
            return self._counter
        return self._base[key]

    def __setitem__(self, key, value):
        self._base[key] = value

    def __contains__(self, key):
        return key == "evalCounter" or key in self._base


class Warmup(LearningRateSchedule):
    """Linear warmup from lr to peak = lr + delta*warmupIteration, then
    `after` continues FROM THE PEAK with a re-zeroed iteration counter
    (not in the 2017 reference — standard add-on for large-batch
    training).  `Warmup(delta, n, after=CosineDecay(T))` is therefore the
    standard continuous ramp-to-peak-then-cosine over n + T iterations."""

    def __init__(self, delta: float, warmup_iteration: int,
                 after: LearningRateSchedule = None):
        self.delta = delta
        self.warmup_iteration = warmup_iteration
        self.after = after or Default()

    def get_lr(self, optim, state):
        neval = state.get("evalCounter", 0)
        if neval < self.warmup_iteration:
            return optim.learning_rate + self.delta * neval
        sub = _ShiftedState(state, neval - self.warmup_iteration)
        peak = optim.learning_rate + self.delta * self.warmup_iteration
        return self.after.get_lr(_PeakLR(optim, peak), sub)


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each active for a given iteration count."""

    def __init__(self):
        self.entries = []  # (schedule, n_iterations)

    def add(self, schedule: LearningRateSchedule, max_iteration: int):
        self.entries.append((schedule, max_iteration))
        return self

    def get_lr(self, optim, state):
        neval = state.get("evalCounter", 0)
        offset = 0
        for sched, n in self.entries:
            if neval < offset + n:
                return sched.get_lr(optim,
                                    _ShiftedState(state, neval - offset))
            offset += n
        sched, n = self.entries[-1]
        return sched.get_lr(optim,
                            _ShiftedState(state, neval - offset + n))
