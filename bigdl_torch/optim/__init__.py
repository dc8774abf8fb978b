"""Inference engines (the training half comes with the training slice)."""

from .optimizer import Predictor

__all__ = ["Predictor"]
