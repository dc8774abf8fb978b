"""The protobuf wire format: a generic codec, no protobuf runtime.

Counterpart of ``bigdl_tpu/utils/pbwire.py``.  BigDL vendors
protoc-generated Java (``caffe/Caffe.java``,
``org/tensorflow/framework/*.java``) to read and write Caffe's
NetParameter and TensorFlow's GraphDef and Event messages; the wire format
is four encodings (varint, fixed64, length-delimited, fixed32), so one
codec and the callers' field tables (``interop/caffe.py``,
``interop/tensorflow.py``, ``visualization/proto.py``) replace it.

Decoding yields (field number, wire type, value) triples; what a field
means lives in the callers.  :class:`Fields` is a dict-like view for the
common reads.  ``field_packed_floats`` takes a numpy array without a
Python list in between (a weight blob of millions of floats).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Sequence, Tuple, Union

__all__ = ["encode_varint", "decode_varint", "tag", "field_varint",
           "field_double", "field_float", "field_bytes", "field_string",
           "field_packed_doubles", "field_packed_floats",
           "field_packed_varints", "iter_fields", "Fields", "zigzag",
           "unzigzag"]


# ---------------------------------------------------------------- encoding

def encode_varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def field_varint(field: int, value: int) -> bytes:
    return tag(field, 0) + encode_varint(value)


def field_double(field: int, value: float) -> bytes:
    return tag(field, 1) + struct.pack("<d", value)


def field_float(field: int, value: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", value)


def field_bytes(field: int, value: bytes) -> bytes:
    return tag(field, 2) + encode_varint(len(value)) + value


def field_string(field: int, value: str) -> bytes:
    return field_bytes(field, value.encode())


def field_packed_doubles(field: int, values: Sequence[float]) -> bytes:
    return field_bytes(field, struct.pack(f"<{len(values)}d", *values))


def field_packed_floats(field: int, values) -> bytes:
    """Accepts a sequence of floats or a numpy array (fast path: no Python
    list materialization for large weight blobs)."""
    import numpy as np
    if isinstance(values, np.ndarray):
        return field_bytes(field,
                           np.ascontiguousarray(values, "<f4").tobytes())
    return field_bytes(field, struct.pack(f"<{len(values)}f", *values))


def field_packed_varints(field: int, values: Sequence[int]) -> bytes:
    return field_bytes(field, b"".join(encode_varint(v) for v in values))


# ---------------------------------------------------------------- decoding

def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, raw_value).  wire 0 -> int,
    1 -> float (as double), 2 -> bytes, 5 -> float (as float32)."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = decode_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = decode_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = decode_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


class Fields:
    """Dict-of-lists view over one message's fields, for schema-driven
    readers: `Fields(buf).int(1)`, `.str(2)`, `.sub(7)` etc."""

    def __init__(self, buf: bytes):
        self._f: Dict[int, List] = {}
        for field, wire, val in iter_fields(buf):
            self._f.setdefault(field, []).append((wire, val))

    def has(self, field: int) -> bool:
        return field in self._f

    def _all(self, field: int) -> List:
        return self._f.get(field, [])

    def int(self, field: int, default: int = 0) -> int:
        vals = self._all(field)
        return int(vals[-1][1]) if vals else default

    def ints(self, field: int) -> List[int]:
        """Repeated varints, handling both packed and unpacked encodings."""
        out: List[int] = []
        for wire, val in self._all(field):
            if wire == 2:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = decode_varint(val, pos)
                    out.append(v)
            else:
                out.append(int(val))
        return out

    def float(self, field: int, default: float = 0.0) -> float:
        vals = self._all(field)
        return float(vals[-1][1]) if vals else default

    def floats(self, field: int) -> List[float]:
        """Repeated float32, packed or not."""
        out: List[float] = []
        for wire, val in self._all(field):
            if wire == 2:
                out.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                out.append(float(val))
        return out

    def doubles(self, field: int) -> List[float]:
        out: List[float] = []
        for wire, val in self._all(field):
            if wire == 2:
                out.extend(struct.unpack(f"<{len(val) // 8}d", val))
            else:
                out.append(float(val))
        return out

    def bytes(self, field: int, default: bytes = b"") -> bytes:
        vals = self._all(field)
        return bytes(vals[-1][1]) if vals else default

    def str(self, field: int, default: str = "") -> str:
        vals = self._all(field)
        return bytes(vals[-1][1]).decode() if vals else default

    def strs(self, field: int) -> List[str]:
        return [bytes(v).decode() for _w, v in self._all(field)]

    def sub(self, field: int) -> "Fields":
        return Fields(self.bytes(field))

    def subs(self, field: int) -> List["Fields"]:
        return [Fields(bytes(v)) for _w, v in self._all(field)]

    def raw(self, field: int) -> List[bytes]:
        return [bytes(v) for _w, v in self._all(field)]
