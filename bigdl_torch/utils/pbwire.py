"""The protobuf wire format, as much as the summary events need.

Counterpart of ``bigdl_tpu/utils/pbwire.py`` (the reference's generic
codec, replacing protoc-generated Java): varints, 64- and 32-bit fixed
fields and length-delimited fields, and :class:`Fields`, a dict-like view
of one message's fields.  Only what ``visualization/proto.py`` uses is
ported; the Caffe and TensorFlow interop codecs come with ROADMAP queue A
item 9.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Sequence, Tuple

__all__ = ["encode_varint", "decode_varint", "tag", "field_varint",
           "field_double", "field_float", "field_bytes", "field_string",
           "field_packed_doubles", "iter_fields", "Fields"]

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

    def float(self, field: int, default: float = 0.0) -> float:
        vals = self._all(field)
        return float(vals[-1][1]) if vals else default

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

    def sub(self, field: int) -> "Fields":
        return Fields(self.bytes(field))

    def subs(self, field: int) -> List["Fields"]:
        return [Fields(bytes(v)) for _w, v in self._all(field)]
