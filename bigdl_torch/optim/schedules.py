"""Learning-rate schedules: ``Default`` (SGD.scala:491).

Counterpart of ``bigdl_tpu/optim/schedules.py`` for what the training
slice uses.  A schedule runs on the host each iteration:
``get_lr(optim, state) -> float``, with ``state`` the driver's dict
(``evalCounter`` 0-based iteration, ``epoch``).
"""

from __future__ import annotations

__all__ = ["LearningRateSchedule", "Default"]


class LearningRateSchedule:
    def get_lr(self, optim, state) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """clr = lr / (1 + neval · lrd)."""

    def get_lr(self, optim, state):
        neval = state.get("evalCounter", 0)
        lrd = getattr(optim, "learning_rate_decay", 0.0)
        return optim.learning_rate / (1 + neval * lrd)
