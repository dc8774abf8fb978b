"""Triggers: when to stop (and, in later slices, validate or checkpoint).

Counterpart of ``bigdl_tpu/optim/trigger.py`` for what the training slice
uses (reference ``optim/Trigger.scala:30``): predicates over the driver's
state dict (``epoch`` and ``neval``, both 1-based).
"""

from __future__ import annotations

__all__ = ["Trigger"]


class Trigger:
    def __init__(self, fn, name="trigger"):
        self._fn = fn
        self.name = name

    def __call__(self, state) -> bool:
        return self._fn(state)

    @staticmethod
    def every_epoch():
        """Fires when ``state["epoch"]`` advances past the value seen at
        the previous firing (or the first call) (:37)."""
        box = {"last": None}

        def fn(state):
            e = state.get("epoch", 1)
            if box["last"] is None:
                box["last"] = e
                return False
            if e > box["last"]:
                box["last"] = e
                return True
            return False

        return Trigger(fn, "everyEpoch")

    @staticmethod
    def several_iteration(interval: int):
        """Fires every ``interval`` iterations (:63)."""
        return Trigger(lambda s: s.get("neval", 1) % interval == 0,
                       f"severalIteration({interval})")

    @staticmethod
    def max_epoch(maximum: int):
        """End-when trigger: epoch > max (:79)."""
        return Trigger(lambda s: s.get("epoch", 1) > maximum,
                       f"maxEpoch({maximum})")

    @staticmethod
    def max_iteration(maximum: int):
        """End-when trigger: neval > max."""
        return Trigger(lambda s: s.get("neval", 1) > maximum,
                       f"maxIteration({maximum})")
