"""TensorBoard Event/Summary messages, hand-encoded over the protobuf
wire codec (``utils/pbwire.py``).

Counterpart of ``bigdl_tpu/visualization/proto.py``, line for line: the
two packages write and read the same bytes.

Reference: BigDL ships protoc-generated Java for these protos and builds
messages in visualization/Summary.scala:95-172.

Field numbers (public tensorflow/core/util/event.proto and
tensorflow/core/framework/summary.proto):
    Event:   wall_time=1 (double), step=2 (int64), file_version=3 (string),
             summary=5 (message)
    Summary: value=1 (repeated message)
    Summary.Value: tag=1 (string), simple_value=2 (float), histo=5 (message)
    HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5 (double),
             bucket_limit=6 bucket=7 (repeated double, packed)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..utils.pbwire import (Fields, decode_varint, encode_varint,
                            field_bytes, field_double, field_float,
                            field_packed_doubles, field_string, field_varint)

__all__ = ["encode_varint", "decode_varint", "scalar_summary",
           "histogram_summary", "event_bytes", "parse_event"]


def scalar_summary(tag: str, value: float) -> bytes:
    """Summary{value {tag, simple_value}} (Summary.scala:95-104)."""
    v = field_string(1, tag) + field_float(2, float(value))
    return field_bytes(1, v)


# TensorBoard's standard exponential bucket boundaries: +/- 1e-12 * 1.1^k
# (reference builds the identical table in Summary.scala:120-146).
def _default_bucket_limits() -> List[float]:
    pos = []
    v = 1e-12
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    return [-x for x in reversed(pos)] + [0.0] + pos + [float("inf")]


_BUCKETS: List[float] = _default_bucket_limits()
_EDGES = np.array([-np.inf] + _BUCKETS[:-1] + [np.inf])


def histogram_summary(tag: str, values: np.ndarray) -> bytes:
    """Summary{value {tag, histo}} with TF exponential buckets; only buckets
    up to the last non-empty one are emitted, as TF does."""
    x = np.asarray(values, dtype=np.float64).ravel()
    if x.size == 0:
        x = np.zeros(1)
    counts, _ = np.histogram(x, bins=_EDGES)
    last = int(np.nonzero(counts)[0].max()) if counts.any() else 0
    histo = (field_double(1, float(x.min())) +
             field_double(2, float(x.max())) +
             field_double(3, float(x.size)) +
             field_double(4, float(x.sum())) +
             field_double(5, float(np.square(x).sum())) +
             field_packed_doubles(6, _BUCKETS[:last + 1]) +
             field_packed_doubles(7, counts[:last + 1].tolist()))
    v = field_string(1, tag) + field_bytes(5, histo)
    return field_bytes(1, v)


def event_bytes(wall_time: float, step: int = 0,
                summary: bytes | None = None,
                file_version: str | None = None) -> bytes:
    out = field_double(1, wall_time)
    if step:
        out += field_varint(2, step)
    if file_version is not None:
        out += field_string(3, file_version)
    if summary is not None:
        out += field_bytes(5, summary)
    return out


def parse_event(buf: bytes) -> Dict:
    """Decode an Event record into {wall_time, step, file_version,
    values: [{tag, simple_value | histo}]} — the read-back path used by
    FileReader (reference: visualization/tensorboard/FileReader.scala)."""
    f = Fields(buf)
    ev = {"wall_time": f.float(1), "step": f.int(2),
          "file_version": f.str(3) or None, "values": []}
    if f.has(5):
        for v in f.sub(5).subs(1):
            value = {"tag": v.str(1) or None,
                     "simple_value": v.float(2) if v.has(2) else None,
                     "histo": _parse_histo(v.sub(5)) if v.has(5) else None}
            ev["values"].append(value)
    return ev


def _parse_histo(f: Fields) -> Dict:
    return {"min": f.float(1), "max": f.float(2), "num": f.float(3),
            "sum": f.float(4), "sum_squares": f.float(5),
            "bucket_limit": f.doubles(6), "bucket": f.doubles(7)}
