"""The port's native host library: record IO, the shard prefetcher and
host batch kernels.

Counterpart of ``bigdl_tpu/utils/native.py``.  The library is the port's
own ``csrc/host/recordio.cc``, ``prefetch.cc`` and ``hostops.cc``, linked
with its CRC32C (``crc32c.cc``, which ``utils/crc32c.py`` binds from this
library), built by the host C++ compiler at first use into
``bigdl_torch/_build/`` (``utils/cuda_build.py`` ``HOST_SOURCES``) and
bound with ``ctypes``; nothing is built
at import.  Where it cannot be built, a one-time warning is logged and every
entry point takes its Python route, as the reference does without its
library: the same bytes and arrays, more slowly.  :func:`is_native_loaded`
says which (it builds the library if it can).

- :class:`NativeRecordWriter`, :class:`NativeRecordReader`: one BDRecord
  shard, written or read frame by frame (``utils/recordio.py`` holds the
  format and the Python route).
- :class:`NativePrefetchReader`: N C++ threads each read whole shards into
  one bounded ring; records interleave across shards, each shard's in its
  file order; one consumer.
- :func:`gather_rows` (stack equal rows into a batch, the batchers'
  collation), :func:`reduce_sum_f32`, :func:`f32_to_bf16` (round to
  nearest even) and :func:`bf16_to_f32`, parallel over
  :func:`set_num_threads` threads where an array is large.
"""

from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np

from . import cuda_build

logger = logging.getLogger("bigdl_torch")

__all__ = ["library", "is_native_loaded", "has_prefetch", "set_num_threads",
           "get_num_threads", "f32_to_bf16", "bf16_to_f32", "gather_rows",
           "reduce_sum_f32", "NativeRecordWriter", "NativeRecordReader",
           "NativePrefetchReader"]

_lock = threading.Lock()
_state = {"lib": None, "tried": False}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, cp, sz = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
    i64 = ctypes.c_int64
    sigs = {
        "record_writer_open": (vp, [cp]),
        "record_writer_write": (ctypes.c_int, [vp, cp, ctypes.c_uint64]),
        "record_writer_close": (ctypes.c_int, [vp]),
        "record_reader_open": (vp, [cp]),
        "record_reader_next": (i64, [vp]),
        "record_reader_data": (vp, [vp]),
        "record_reader_close": (None, [vp]),
        "prefetch_open": (vp, [ctypes.POINTER(cp), i64, i64, i64]),
        "prefetch_next": (i64, [vp]),
        "prefetch_data": (vp, [vp]),
        "prefetch_close": (None, [vp]),
        "set_num_threads": (None, [ctypes.c_int]),
        "get_num_threads": (ctypes.c_int, []),
        "f32_to_bf16": (None, [vp, vp, sz]),
        "bf16_to_f32": (None, [vp, vp, sz]),
        "gather_rows": (None, [vp, ctypes.POINTER(vp), sz, sz]),
        "reduce_sum_f32": (None, [vp, ctypes.POINTER(vp), ctypes.c_int,
                                  sz]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, "bigdl_torch_" + name)
        fn.restype, fn.argtypes = res, args
    return lib


def library():
    """The compiled library, built and bound on first use; raises if it
    cannot be built."""
    with _lock:
        if _state["lib"] is None:
            _state["lib"] = _bind(cuda_build.load_host())
        return _state["lib"]


def _lib():
    """The library, or None (after one warning) where it cannot be
    built."""
    if _state["lib"] is None and not _state["tried"]:
        _state["tried"] = True
        try:
            library()
        except (RuntimeError, OSError) as e:
            logger.warning("native host library unavailable (%s); the "
                           "record IO and batch kernels take their Python "
                           "routes", e)
    return _state["lib"]


def is_native_loaded() -> bool:
    """(reference ``MKL.isMKLLoaded``): the compiled routes run."""
    return _lib() is not None


def has_prefetch() -> bool:
    """The library's shard prefetcher is available (the port's library
    always has it when it loads)."""
    return is_native_loaded()


def set_num_threads(n: int) -> None:
    """(reference ``MKL.setNumThreads``): threads of the batch kernels."""
    lib = _lib()
    if lib is not None:
        lib.bigdl_torch_set_num_threads(n)


def get_num_threads() -> int:
    lib = _lib()
    return lib.bigdl_torch_get_num_threads() if lib is not None else 1


def _bf16_round(arr: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits, round to nearest even, NaN kept quiet with
    its sign (the kernel's ``F32ToBf16``)."""
    bits = arr.view(np.uint32)
    lsb = (bits >> 16) & 1
    out = ((bits + 0x7FFF + lsb) >> 16).astype(np.uint16)
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    return np.where(nan, ((bits >> 16) | 0x0040).astype(np.uint16), out)


def f32_to_bf16(arr: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (its bits as uint16), round to nearest even."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    lib = _lib()
    if lib is None or not arr.size:
        return _bf16_round(arr)
    out = np.empty(arr.shape, dtype=np.uint16)
    lib.bigdl_torch_f32_to_bf16(arr.ctypes.data, out.ctypes.data, arr.size)
    return out


def bf16_to_f32(arr: np.ndarray) -> np.ndarray:
    """bf16 bits (uint16) -> float32, exactly."""
    arr = np.ascontiguousarray(arr, dtype=np.uint16)
    lib = _lib()
    if lib is None or not arr.size:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    out = np.empty(arr.shape, dtype=np.float32)
    lib.bigdl_torch_bf16_to_f32(arr.ctypes.data, out.ctypes.data, arr.size)
    return out


def gather_rows(rows) -> np.ndarray:
    """Stack equal-shape arrays into one batch with the parallel memcpy
    kernel; ``np.stack`` for mixed shapes or dtypes (which promotes or
    raises exactly as it would without the library)."""
    rows = [np.ascontiguousarray(r) for r in rows]
    if not rows:
        return np.empty((0,))
    lib = _lib()
    if lib is None or any(r.shape != rows[0].shape or
                          r.dtype != rows[0].dtype for r in rows[1:]):
        return np.stack(rows)
    out = np.empty((len(rows),) + rows[0].shape, dtype=rows[0].dtype)
    ptrs = (ctypes.c_void_p * len(rows))(*[r.ctypes.data for r in rows])
    lib.bigdl_torch_gather_rows(out.ctypes.data, ptrs, rows[0].nbytes,
                                len(rows))
    return out


def reduce_sum_f32(bufs) -> np.ndarray:
    """Elementwise sum of equal-shape float32 arrays, in order."""
    bufs = [np.ascontiguousarray(b, dtype=np.float32) for b in bufs]
    lib = _lib()
    if lib is None or not bufs:
        return np.sum(bufs, axis=0, dtype=np.float32)
    if any(b.shape != bufs[0].shape for b in bufs[1:]):
        raise ValueError("reduce_sum_f32 requires equal shapes")
    out = np.empty_like(bufs[0])
    ptrs = (ctypes.c_void_p * len(bufs))(*[b.ctypes.data for b in bufs])
    lib.bigdl_torch_reduce_sum_f32(out.ctypes.data, ptrs, len(bufs),
                                   out.size)
    return out


class _Handle:
    """A C handle closed once, on ``close()``, at a ``with`` block's end or
    when collected."""

    _close_fn = None

    def close(self) -> None:
        if self._h:
            getattr(library(), self._close_fn)(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


class NativeRecordWriter(_Handle):
    """A BDRecord shard written frame by frame in C++."""

    def __init__(self, path: str):
        self._h = None
        self._h = library().bigdl_torch_record_writer_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path!r} for writing")

    def write(self, payload: bytes) -> None:
        if library().bigdl_torch_record_writer_write(
                self._h, payload, len(payload)) != 0:
            raise IOError("record write failed")

    def close(self) -> None:
        if self._h:
            rc = library().bigdl_torch_record_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("record writer close failed (flush error)")


class NativeRecordReader(_Handle):
    """A BDRecord shard's payloads, in file order, read in C++."""

    _close_fn = "bigdl_torch_record_reader_close"

    def __init__(self, path: str):
        self._h = None
        self._path = path
        self._h = library().bigdl_torch_record_reader_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path!r}")

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if not self._h:
            raise StopIteration
        lib = library()
        n = lib.bigdl_torch_record_reader_next(self._h)
        if n == -1:
            raise StopIteration
        if n < 0:
            # typed as the Python reader's; not resumable, since the C
            # reader's position after a bad frame is undefined
            from .recordio import CorruptRecord
            raise CorruptRecord(
                f"corrupt record (crc mismatch) in {self._path!r}",
                path=self._path, resumable=False)
        return ctypes.string_at(lib.bigdl_torch_record_reader_data(self._h),
                                n)


class NativePrefetchReader(_Handle):
    """N C++ reader threads stream whole shards into a bounded ring of
    ``capacity`` records; iterating yields payloads.  Records interleave
    across shards (each shard's in file order); one consumer."""

    _close_fn = "bigdl_torch_prefetch_close"

    def __init__(self, paths, num_threads: int = 4, capacity: int = 256):
        self._h = None
        paths = [str(p) for p in paths]
        if not paths:
            raise ValueError("no shard paths")
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = library().bigdl_torch_prefetch_open(
            arr, len(paths), num_threads, capacity)
        if not self._h:
            raise IOError(f"cannot open a prefetcher over {len(paths)} "
                          "shards")

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if not self._h:
            raise StopIteration
        lib = library()
        n = lib.bigdl_torch_prefetch_next(self._h)
        if n == -1:
            raise StopIteration
        if n < 0:
            raise IOError("prefetch: IO error or corrupt record")
        return ctypes.string_at(lib.bigdl_torch_prefetch_data(self._h), n)
