"""Java Object Serialization Stream codec (reader and writer), pure Python.

Counterpart of ``bigdl_tpu/interop/javaser.py``, the same code: nothing
in it is JAX.  The reference's native model format is Java serialization
(``Module.save`` -> ``File.save`` -> ``ObjectOutputStream.writeObject``,
``nn/Module.scala:41-43``, ``utils/File.scala:25``), so loading a file
written by the JVM BigDL means parsing the JDK's object-stream protocol
(Java Object Serialization Specification, section 6).  The stream is
self-describing: every object carries its class descriptor (name,
serialVersionUID, typed field list, super chain), so the parser needs no
knowledge of BigDL's classes; ``interop/bigdl.py`` picks the fields it
understands.

Implemented: objects (class hierarchies and writeObject custom data
included), primitive and object arrays (numpy through ``np.frombuffer``
and ``tobytes``), short and long strings, enums, class literals, block
data, back-references, TC_NULL.  Proxies, TC_RESET and TC_EXCEPTION
raise; the reference's writers emit none of them.  The writer emits the
same protocol, byte for byte as the JAX package's.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["JavaObject", "JavaClassDesc", "JavaArray", "JavaEnum",
           "load_stream", "loads", "JavaWriter"]

_MAGIC = 0xACED
_VERSION = 5

TC_NULL = 0x70
TC_REFERENCE = 0x71
TC_CLASSDESC = 0x72
TC_OBJECT = 0x73
TC_STRING = 0x74
TC_ARRAY = 0x75
TC_CLASS = 0x76
TC_BLOCKDATA = 0x77
TC_ENDBLOCKDATA = 0x78
TC_RESET = 0x79
TC_BLOCKDATALONG = 0x7A
TC_EXCEPTION = 0x7B
TC_LONGSTRING = 0x7C
TC_PROXYCLASSDESC = 0x7D
TC_ENUM = 0x7E
_BASE_HANDLE = 0x7E0000

SC_WRITE_METHOD = 0x01
SC_SERIALIZABLE = 0x02
SC_EXTERNALIZABLE = 0x04
SC_BLOCK_DATA = 0x08

# primitive field/array typecodes -> (struct format, numpy dtype)
_PRIM = {
    "B": (">b", np.int8), "C": (">H", np.uint16), "D": (">d", np.float64),
    "F": (">f", np.float32), "I": (">i", np.int32), "J": (">q", np.int64),
    "S": (">h", np.int16), "Z": (">?", np.bool_),
}


@dataclass
class JavaClassDesc:
    name: str
    suid: int
    flags: int
    fields: List[Tuple[str, str, Optional[str]]]  # (typecode, name, signature)
    super_desc: Optional["JavaClassDesc"]
    annotations: List[Any] = field(default_factory=list)

    def hierarchy(self):
        """Super-first chain, the order classdata appears in the stream."""
        chain = []
        c = self
        while c is not None:
            chain.append(c)
            c = c.super_desc
        return list(reversed(chain))


@dataclass
class JavaObject:
    classdesc: JavaClassDesc
    fields: Dict[str, Any] = field(default_factory=dict)  # flattened
    class_fields: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    annotations: Dict[str, List[Any]] = field(default_factory=dict)

    @property
    def classname(self) -> str:
        return self.classdesc.name

    def __repr__(self):
        return f"JavaObject({self.classname}, {list(self.fields)})"


@dataclass
class JavaArray:
    classdesc: JavaClassDesc
    values: Any  # numpy array for primitives, list for object arrays

    @property
    def classname(self) -> str:
        return self.classdesc.name


@dataclass
class JavaEnum:
    classdesc: JavaClassDesc
    constant: str


class _Reader:
    def __init__(self, f):
        self.f = f
        self.handles: List[Any] = []

    # -- primitives ----------------------------------------------------
    def _read(self, n):
        b = self.f.read(n)
        if len(b) != n:
            raise EOFError(f"truncated stream: wanted {n} bytes, got {len(b)}")
        return b

    def u1(self):
        return self._read(1)[0]

    def u2(self):
        return struct.unpack(">H", self._read(2))[0]

    def i4(self):
        return struct.unpack(">i", self._read(4))[0]

    def i8(self):
        return struct.unpack(">q", self._read(8))[0]

    def utf(self):
        return self._read(self.u2()).decode("utf-8", errors="replace")

    def long_utf(self):
        n = struct.unpack(">Q", self._read(8))[0]
        return self._read(n).decode("utf-8", errors="replace")

    def _new_handle(self, obj):
        self.handles.append(obj)
        return obj

    # -- grammar -------------------------------------------------------
    def stream(self):
        if self.u2() != _MAGIC or self.u2() != _VERSION:
            raise ValueError("not a Java object serialization stream")
        out = []
        while True:
            b = self.f.read(1)
            if not b:
                return out
            out.append(self.content(b[0]))

    def content(self, tc=None):
        if tc is None:
            tc = self.u1()
        if tc == TC_OBJECT:
            return self.object_()
        if tc == TC_CLASSDESC:
            return self.new_classdesc()
        if tc == TC_REFERENCE:
            h = self.i4() - _BASE_HANDLE
            return self.handles[h]
        if tc == TC_STRING:
            return self._new_handle(self.utf())
        if tc == TC_LONGSTRING:
            return self._new_handle(self.long_utf())
        if tc == TC_ARRAY:
            return self.array_()
        if tc == TC_NULL:
            return None
        if tc == TC_CLASS:
            cd = self.classdesc()
            self._new_handle(cd)
            return cd
        if tc == TC_BLOCKDATA:
            return self._read(self.u1())
        if tc == TC_BLOCKDATALONG:
            return self._read(self.i4())
        if tc == TC_ENUM:
            cd = self.classdesc()
            e = JavaEnum(cd, "")
            self._new_handle(e)
            e.constant = self.content()
            return e
        raise ValueError(f"unsupported stream element 0x{tc:02x}")

    def classdesc(self) -> Optional[JavaClassDesc]:
        tc = self.u1()
        if tc == TC_CLASSDESC:
            return self.new_classdesc()
        if tc == TC_NULL:
            return None
        if tc == TC_REFERENCE:
            h = self.i4() - _BASE_HANDLE
            cd = self.handles[h]
            if not isinstance(cd, JavaClassDesc):
                raise ValueError("classdesc reference to a non-classdesc")
            return cd
        if tc == TC_PROXYCLASSDESC:
            raise ValueError("dynamic proxy class descriptors not supported")
        raise ValueError(f"bad classDesc tag 0x{tc:02x}")

    def new_classdesc(self) -> JavaClassDesc:
        name = self.utf()
        suid = self.i8()
        cd = JavaClassDesc(name, suid, 0, [], None)
        self._new_handle(cd)
        cd.flags = self.u1()
        nfields = self.u2()
        for _ in range(nfields):
            t = chr(self.u1())
            fname = self.utf()
            sig = self.content() if t in "[L" else None  # String (or ref)
            cd.fields.append((t, fname, sig))
        # classAnnotation: contents until TC_ENDBLOCKDATA
        while True:
            tc = self.u1()
            if tc == TC_ENDBLOCKDATA:
                break
            cd.annotations.append(self.content(tc))
        cd.super_desc = self.classdesc()
        return cd

    def object_(self) -> JavaObject:
        cd = self.classdesc()
        obj = JavaObject(cd)
        self._new_handle(obj)
        for cls in cd.hierarchy():
            if not cls.flags & (SC_SERIALIZABLE | SC_EXTERNALIZABLE):
                continue
            vals: Dict[str, Any] = {}
            if cls.flags & SC_SERIALIZABLE:
                for t, fname, _sig in cls.fields:
                    if t in _PRIM:
                        fmt, _ = _PRIM[t]
                        v = struct.unpack(fmt,
                                          self._read(struct.calcsize(fmt)))[0]
                    else:
                        v = self.content()
                    vals[fname] = v
                obj.class_fields[cls.name] = vals
                obj.fields.update(vals)
                if cls.flags & SC_WRITE_METHOD:
                    obj.annotations[cls.name] = self._annotation()
            else:  # externalizable
                if not cls.flags & SC_BLOCK_DATA:
                    raise ValueError(
                        f"{cls.name}: pre-JDK1.2 external format unsupported")
                obj.annotations[cls.name] = self._annotation()
        return obj

    def _annotation(self):
        items = []
        while True:
            tc = self.u1()
            if tc == TC_ENDBLOCKDATA:
                return items
            items.append(self.content(tc))

    def array_(self) -> JavaArray:
        cd = self.classdesc()
        arr = JavaArray(cd, None)
        self._new_handle(arr)
        n = self.i4()
        comp = cd.name[1] if cd.name.startswith("[") else "L"
        if comp in _PRIM:
            fmt, dt = _PRIM[comp]
            raw = self._read(n * struct.calcsize(fmt))
            arr.values = np.frombuffer(raw, dtype=np.dtype(dt).newbyteorder(">"),
                                       count=n).astype(dt)
        else:
            arr.values = [self.content() for _ in range(n)]
        return arr


def load_stream(f) -> List[Any]:
    """Parse a whole stream; returns the list of top-level contents."""
    return _Reader(f).stream()


def loads(data: bytes) -> List[Any]:
    return load_stream(io.BytesIO(data))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class JavaWriter:
    """Protocol-faithful writer for the subset the reader understands.

    Descriptors and values are JavaClassDesc / JavaObject / JavaArray /
    str / None — the same object model `load_stream` returns, so
    read(write(x)) is an exact roundtrip.  Handle assignment mirrors the
    spec (descs, objects, arrays and strings each get the next handle);
    repeated descriptors and strings are emitted as TC_REFERENCE."""

    def __init__(self):
        self.buf = io.BytesIO()
        self.handles: Dict[int, int] = {}   # id(obj) -> handle index
        self.string_handles: Dict[str, int] = {}
        self.next_handle = 0
        self.buf.write(struct.pack(">HH", _MAGIC, _VERSION))

    def getvalue(self) -> bytes:
        return self.buf.getvalue()

    # -- low-level -----------------------------------------------------
    def _u1(self, v):
        self.buf.write(bytes([v]))

    def _utf(self, s):
        b = s.encode("utf-8")
        self.buf.write(struct.pack(">H", len(b)))
        self.buf.write(b)

    def _assign(self, obj) -> int:
        h = self.next_handle
        self.next_handle += 1
        if isinstance(obj, str):
            self.string_handles[obj] = h
        else:
            self.handles[id(obj)] = h
        return h

    def _ref(self, h):
        self._u1(TC_REFERENCE)
        self.buf.write(struct.pack(">i", _BASE_HANDLE + h))

    # -- grammar -------------------------------------------------------
    def write_content(self, v):
        if v is None:
            self._u1(TC_NULL)
        elif isinstance(v, str):
            self.write_string(v)
        elif isinstance(v, JavaObject):
            self.write_object(v)
        elif isinstance(v, JavaArray):
            self.write_array(v)
        elif isinstance(v, (bytes, bytearray)):
            # blockdata: short frame when it fits, TC_BLOCKDATALONG above
            # 255 bytes (ObjectOutputStream's own split; the reader accepts
            # both).  Previously >255 crashed in bytes([len]).
            v = bytes(v)
            if len(v) <= 0xFF:
                self._u1(TC_BLOCKDATA)
                self._u1(len(v))
                self.buf.write(v)
            else:
                self._u1(TC_BLOCKDATALONG)
                self.buf.write(struct.pack(">i", len(v)))
                self.buf.write(v)
        else:
            raise TypeError(f"cannot serialize {type(v).__name__}")

    def write_string(self, s: str):
        if s in self.string_handles:
            self._ref(self.string_handles[s])
            return
        self._u1(TC_STRING)
        self._assign(s)
        self._utf(s)

    def write_classdesc(self, cd: Optional[JavaClassDesc]):
        if cd is None:
            self._u1(TC_NULL)
            return
        if id(cd) in self.handles:
            self._ref(self.handles[id(cd)])
            return
        self._u1(TC_CLASSDESC)
        self._utf(cd.name)
        self.buf.write(struct.pack(">q", cd.suid))
        self._assign(cd)
        self._u1(cd.flags)
        self.buf.write(struct.pack(">H", len(cd.fields)))
        for t, fname, sig in cd.fields:
            self._u1(ord(t))
            self._utf(fname)
            if t in "[L":
                self.write_string(sig)
        for a in cd.annotations:
            self.write_content(a)
        self._u1(TC_ENDBLOCKDATA)
        self.write_classdesc(cd.super_desc)

    def write_object(self, obj: JavaObject):
        if id(obj) in self.handles:
            self._ref(self.handles[id(obj)])
            return
        self._u1(TC_OBJECT)
        self.write_classdesc(obj.classdesc)
        self._assign(obj)
        for cls in obj.classdesc.hierarchy():
            if not cls.flags & SC_SERIALIZABLE:
                continue
            vals = obj.class_fields.get(cls.name, obj.fields)
            for t, fname, _sig in cls.fields:
                v = vals[fname]
                if t in _PRIM:
                    fmt, _ = _PRIM[t]
                    self.buf.write(struct.pack(fmt, v))
                else:
                    self.write_content(v)
            if cls.flags & SC_WRITE_METHOD:
                for a in obj.annotations.get(cls.name, []):
                    self.write_content(a)
                self._u1(TC_ENDBLOCKDATA)

    def write_array(self, arr: JavaArray):
        if id(arr) in self.handles:
            self._ref(self.handles[id(arr)])
            return
        self._u1(TC_ARRAY)
        self.write_classdesc(arr.classdesc)
        self._assign(arr)
        comp = arr.classdesc.name[1]
        if comp in _PRIM:
            vals = np.asarray(arr.values)
            self.buf.write(struct.pack(">i", vals.size))
            fmt, dt = _PRIM[comp]
            self.buf.write(
                vals.astype(np.dtype(dt).newbyteorder(">")).tobytes())
        else:
            self.buf.write(struct.pack(">i", len(arr.values)))
            for v in arr.values:
                self.write_content(v)
