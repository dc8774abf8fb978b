"""CRC32C (Castagnoli) for the checkpoint frame, compiled or in Python.

Counterpart of ``bigdl_tpu/utils/recordio.py`` ``crc32c_update`` and its
native route (``bigdl_tpu/utils/native.py``).  The compiled route is the
port's own ``csrc/host/crc32c.cc`` (SSE4.2 or a sliced table), part of the
port's host library (``utils/native.py`` :func:`~.native.library`, built
with the host C++ compiler at first use).  Where it cannot be built, a one-time warning is logged
and the pure-Python table loop runs, as the reference does without its
native library; it gives the same numbers, slowly (a few MB/s).
:func:`route` says which one runs.  :func:`masked_crc32c` is the
TFRecord-masked CRC of the summary event files (the reference's
``recordio.masked_crc32c``).
"""

from __future__ import annotations

import ctypes
import logging
import threading

from . import native as host

logger = logging.getLogger("bigdl_torch")

__all__ = ["crc32c_update", "crc32c_table", "masked_crc32c", "route",
           "native"]

_lock = threading.Lock()
_state = {"fn": None, "tried": False, "hardware": False}
_TABLE = None


def native():
    """The compiled ``extend(crc, data, len)``, built on first use; raises
    if it cannot be built."""
    with _lock:
        if _state["fn"] is None:
            lib = host.library()
            fn = lib.bigdl_torch_crc32c_extend
            fn.restype = ctypes.c_uint32
            fn.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
            lib.bigdl_torch_crc32c_hardware.restype = ctypes.c_int
            _state["hardware"] = bool(lib.bigdl_torch_crc32c_hardware())
            _state["fn"] = fn
        return _state["fn"]


def _compiled():
    """The compiled function, or None (after one warning) where it cannot
    be built."""
    if _state["fn"] is None and not _state["tried"]:
        _state["tried"] = True
        try:
            native()
        except (RuntimeError, OSError) as e:
            logger.warning("CRC32C: the compiled route is unavailable (%s); "
                           "using the Python table loop", e)
    return _state["fn"]


def route() -> str:
    """``"compiled-sse4.2"`` or ``"compiled-table"`` where the compiled
    route runs, ``"python-table"`` otherwise."""
    if _compiled() is None:
        return "python-table"
    return "compiled-sse4.2" if _state["hardware"] else "compiled-table"


def _table():
    global _TABLE
    if _TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _TABLE = table
    return _TABLE


def crc32c_table(crc: int, data: bytes) -> int:
    """The pure-Python table loop (the reference's fallback)."""
    tb = _table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = tb[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c_update(crc: int, data) -> int:
    """Continue a finalized CRC32C over more bytes (seed 0 for the first
    chunk): crc32c_update(crc32c_update(0, a), b) == crc32c(a + b)."""
    fn = _compiled()
    data = bytes(data)
    if fn is not None:
        return fn(crc, data, len(data))
    return crc32c_table(crc, data)


def masked_crc32c(data: bytes) -> int:
    """The TFRecord CRC mask over CRC32C(data) (RecordWriter.scala:44-57)."""
    crc = crc32c_update(0, data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF
