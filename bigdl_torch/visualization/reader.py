"""Read scalars and histograms back out of TensorBoard event files.

Counterpart of ``bigdl_tpu/visualization/reader.py``.

Reference: visualization/tensorboard/FileReader.scala — used by the specs and
by TrainSummary.readScalar."""

from __future__ import annotations

import glob
import os
import struct
from typing import Dict, Iterator, List, Tuple

from . import proto

__all__ = ["list_events", "read_scalar"]


def _iter_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            f.read(4)  # header crc (verified by the record tests; skip here)
            (length,) = struct.unpack("<Q", header)
            payload = f.read(length)
            if len(payload) < length:
                return
            f.read(4)  # payload crc
            yield payload


def list_events(log_dir: str) -> Iterator[Dict]:
    """All events in a log dir, file-order then record-order."""
    for path in sorted(glob.glob(os.path.join(log_dir,
                                              "events.out.tfevents.*"))):
        for rec in _iter_records(path):
            yield proto.parse_event(rec)


def read_scalar(log_dir: str, tag: str) -> List[Tuple[int, float, float]]:
    """[(step, value, wall_time)] for one scalar tag
    (reference: TrainSummary.readScalar -> FileReader.readScalar)."""
    out = []
    for ev in list_events(log_dir):
        for v in ev["values"]:
            if v["tag"] == tag and v["simple_value"] is not None:
                out.append((ev["step"], v["simple_value"], ev["wall_time"]))
    return out
