"""Visualization: TensorBoard-compatible training summaries.

Reference: visualization/{Summary,TrainSummary,ValidationSummary}.scala —
`TrainSummary(logDir, appName)` writes scalars {Loss, Throughput,
LearningRate} (+ optional per-parameter histograms) to
`<logDir>/<appName>/train`, `ValidationSummary` to `.../validation`; hooked
from the driver loop at optim/DistriOptimizer.scala:345-363,426-456.  Event
files are standard TensorBoard TFRecord files, so `tensorboard --logdir`
works unchanged.  Counterpart of ``bigdl_tpu/visualization``: the two
packages read each other's event files."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import proto
from .reader import read_scalar
from .writer import FileWriter

__all__ = ["Summary", "TrainSummary", "ValidationSummary",
           "FileWriter", "proto", "read_scalar"]


class Summary:
    """Common machinery of Train/ValidationSummary (Summary.scala:40-90)."""

    _subdir = ""

    def __init__(self, log_dir: str, app_name: str):
        self.log_dir = log_dir
        self.app_name = app_name
        self.summary_dir = os.path.join(log_dir, app_name, self._subdir)
        self._writer: Optional[FileWriter] = None

    @property
    def writer(self) -> FileWriter:
        if self._writer is None:
            self._writer = FileWriter(self.summary_dir)
        return self._writer

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self.writer.add_summary(proto.scalar_summary(tag, value), step)
        return self

    def add_histogram(self, tag: str, values: np.ndarray,
                      step: int) -> "Summary":
        self.writer.add_summary(proto.histogram_summary(tag, values), step)
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float, float]]:
        """(reference: Summary.readScalar)"""
        self.flush()
        return read_scalar(self.summary_dir, tag)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class TrainSummary(Summary):
    """Training-side summary with per-tag triggers
    (TrainSummary.scala:32; setSummaryTrigger restricted to the same four
    tags as the reference)."""

    _subdir = "train"
    _allowed_triggers = ("LearningRate", "Loss", "Throughput", "Parameters")

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name)
        self._triggers: Dict[str, object] = {}

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        if name not in self._allowed_triggers:
            raise ValueError(
                f"Only {self._allowed_triggers} triggers are supported")
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(Summary):
    """Validation metrics (ValidationSummary.scala)."""

    _subdir = "validation"
