"""Triggers: when to validate, checkpoint or stop.

Counterpart of ``bigdl_tpu/optim/trigger.py`` (reference
``optim/Trigger.scala:30``: ``everyEpoch`` (:37), ``severalIteration``
(:63), ``maxEpoch`` (:79), ``maxIteration``, ``maxScore``, ``minLoss``),
with the reference's ``plateau``, ``and_`` and ``or_``: predicates over
the driver's state dict (``epoch`` and ``neval``, both 1-based; ``loss``;
``score``, ``val_loss`` and ``val_obs`` once validation has run).
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

    @staticmethod
    def max_score(maximum: float):
        """Fires once the validation score passes ``maximum``."""
        return Trigger(lambda s: s.get("score", float("-inf")) > maximum,
                       f"maxScore({maximum})")

    @staticmethod
    def min_loss(minimum: float):
        """Fires once the training loss falls under ``minimum``."""
        return Trigger(lambda s: s.get("loss", float("inf")) < minimum,
                       f"minLoss({minimum})")

    @staticmethod
    def plateau(monitor: str = "val_loss", patience: int = 3,
                mode: str = "min", min_delta: float = 0.0,
                counter: str = "val_obs"):
        """Fires when ``state[monitor]`` has not improved for ``patience``
        consecutive observations: early stopping (the reference's Plateau
        policy, SGD.scala:534, applied to the end of training).  A new
        observation is one where ``state[counter]`` moved (the Optimizer
        adds one to ``val_obs`` at every validation, so a constant value
        still counts); with ``counter=None`` a change of the value is one.
        Once fired it stays fired: the driver checks end triggers at
        several points."""
        sign = 1.0 if mode == "min" else -1.0
        box = {"best": None, "bad": 0, "last": None, "tick": None,
               "fired": False}

        def fn(state):
            if box["fired"]:
                return True
            v = state.get(monitor)
            if v is None:
                return False
            if counter is not None and counter in state:
                if state[counter] == box["tick"]:
                    return False        # the observation seen last call
                box["tick"] = state[counter]
            elif v == box["last"]:
                return False
            box["last"] = v
            if box["best"] is None or \
                    sign * v < sign * box["best"] - min_delta:
                box["best"] = v
                box["bad"] = 0
                return False
            box["bad"] += 1
            box["fired"] = box["bad"] >= patience
            return box["fired"]

        return Trigger(fn, f"plateau({monitor},{patience})")

    @staticmethod
    def and_(*triggers):
        return Trigger(lambda s: all(t(s) for t in triggers), "and")

    @staticmethod
    def or_(*triggers):
        return Trigger(lambda s: any(t(s) for t in triggers), "or")
