"""Training and inference engines, optimization methods, triggers."""

from .method import SGD, OptimMethod
from .optimizer import NonFiniteLossError, Optimizer, Predictor
from .schedules import Default, LearningRateSchedule
from .trigger import Trigger

__all__ = ["Optimizer", "Predictor", "NonFiniteLossError", "OptimMethod",
           "SGD", "LearningRateSchedule", "Default", "Trigger"]
