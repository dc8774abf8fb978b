"""BDRecord: the sharded record-file format the training corpora live in.

Counterpart of ``bigdl_tpu/utils/recordio.py`` (reference: the Hadoop
SequenceFiles of ``DataSet.SeqFileFolder``, ``dataset/DataSet.scala:319``).
Per record, little-endian::

    u64  length
    u32  masked crc32c of the 8-byte length field
    <length bytes>
    u32  masked crc32c of the payload

which is TFRecord's framing and mask, so both packages write the same bytes
and read each other's shards.  The CRC32C is the port's
(``utils/crc32c.py``); whole shards go through the compiled codec
(``utils/native.py``) where it builds, through the Python one here
otherwise.

Payloads are pickles.  :func:`loads` reads them without importing the JAX
package: a ``Sample``, ``MiniBatch`` or ``LabeledImage`` that the reference
wrote becomes the port's class of the same name and fields, any other
``bigdl_tpu`` global raises :class:`ReferenceGlobalError`, and
package-neutral records (dicts of numpy arrays, as ``record_generator``
writes them) pass as they are.

Corruption raises :class:`CorruptRecord` (``path``, ``offset`` of the
record's start, ``resumable``).  Reads fail loud unless given a
:class:`SkipBudget` (``BIGDL_TORCH_DATA_SKIP_BUDGET``), which quarantines up
to N resumable corrupt records per pass, logged and counted
(:func:`quarantine_stats`).  The ``data.record`` chaos point
(``utils/chaos.py``) mutates a payload before its CRC check, so injected
corruption takes the real detection path; skipping or an armed point uses
the Python reader, which can resync and inject.
"""

from __future__ import annotations

import glob
import io
import logging
import os
import pickle
import struct
from typing import Any, Iterable, Iterator, List, Optional

from . import chaos
from .crc32c import crc32c_update

logger = logging.getLogger("bigdl_torch")

__all__ = ["write_records", "read_records", "count_records",
           "write_record_bytes", "read_record_bytes", "masked_crc32c",
           "CorruptRecord", "SkipBudget", "quarantine_stats",
           "reset_quarantine_stats", "loads", "ReferenceGlobalError",
           "shard_paths"]


class CorruptRecord(IOError, ValueError):
    """A record whose CRC, framing or payload failed verification.

    ``path`` and ``offset`` (the record's first byte, or None where
    unknown) locate it; ``resumable`` says whether the stream stands at
    the next record (False for a corrupt length header: the length itself
    is untrusted, so the error stays fatal whatever the budget)."""

    def __init__(self, message: str, path: Optional[str] = None,
                 offset: Optional[int] = None, resumable: bool = True):
        super().__init__(message)
        self.path = path
        self.offset = offset
        self.resumable = resumable


class ReferenceGlobalError(pickle.UnpicklingError):
    """A pickle names a global of the JAX package that has no plain-data
    counterpart in the port."""


#: the reference's plain-data record classes -> the port's
_REFERENCE_CLASSES = {
    ("bigdl_tpu.dataset.sample", "Sample"):
        ("bigdl_torch.dataset.sample", "Sample"),
    ("bigdl_tpu.dataset.sample", "MiniBatch"):
        ("bigdl_torch.dataset.sample", "MiniBatch"),
    ("bigdl_tpu.dataset.image", "LabeledImage"):
        ("bigdl_torch.dataset.image", "LabeledImage"),
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "bigdl_tpu" or module.startswith("bigdl_tpu."):
            target = _REFERENCE_CLASSES.get((module, name))
            if target is None:
                raise ReferenceGlobalError(
                    f"the pickle names {module}.{name}, a class of the JAX "
                    "package with no counterpart the port reads")
            module, name = target
        return super().find_class(module, name)


def loads(payload: bytes) -> Any:
    """Unpickle a record without importing the JAX package."""
    return _Unpickler(io.BytesIO(payload)).load()


# process-wide quarantine counters
_QUARANTINE_STATS = {"records": 0}


def quarantine_stats() -> dict:
    return dict(_QUARANTINE_STATS)


def reset_quarantine_stats() -> None:
    _QUARANTINE_STATS["records"] = 0


class SkipBudget:
    """Bounded corrupt-record quarantine for one data pass.

    ``budget=None`` reads ``BIGDL_TORCH_DATA_SKIP_BUDGET`` (default 0:
    fail loud).  ``quarantine(exc)`` is True when the record was absorbed
    (logged and counted); False means the budget is spent or the error is
    not resumable, and the caller re-raises."""

    def __init__(self, budget: Optional[int] = None):
        if budget is None:
            from . import config
            budget = config.get_int("DATA_SKIP_BUDGET", 0)
        self.budget = int(budget)
        self.quarantined: List[tuple] = []  # (path, offset, reason)

    @property
    def count(self) -> int:
        return len(self.quarantined)

    def quarantine(self, exc: CorruptRecord) -> bool:
        if not getattr(exc, "resumable", False) or self.count >= self.budget:
            return False
        self.quarantined.append((exc.path, exc.offset, str(exc)))
        _QUARANTINE_STATS["records"] += 1
        logger.warning(
            "data: quarantined corrupt record %d/%d in %s at offset %s: %s",
            self.count, self.budget, exc.path, exc.offset, exc)
        return True


def masked_crc32c(data: bytes) -> int:
    """The TFRecord mask over CRC32C(data) (RecordWriter.scala:44-57)."""
    crc = crc32c_update(0, data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def write_record_bytes(f, payload: bytes) -> None:
    header = struct.pack("<Q", len(payload))
    f.write(header)
    f.write(struct.pack("<I", masked_crc32c(header)))
    f.write(payload)
    f.write(struct.pack("<I", masked_crc32c(payload)))


def read_record_bytes(f, path: Optional[str] = None) -> bytes:
    """One framed record; raises :class:`CorruptRecord` on any CRC or
    truncation failure (a header CRC failure is not resumable: the stream
    cannot resync), ``EOFError`` at a clean end."""
    offset = None
    try:
        offset = f.tell()
    except (OSError, AttributeError):
        pass
    header = f.read(8)
    if not header:
        raise EOFError
    if len(header) < 8:
        raise CorruptRecord(f"truncated record header in {path!r}",
                            path=path, offset=offset)
    (length,) = struct.unpack("<Q", header)
    hcrc_raw = f.read(4)
    if len(hcrc_raw) < 4:
        raise CorruptRecord(f"truncated record header crc in {path!r}",
                            path=path, offset=offset)
    (hcrc,) = struct.unpack("<I", hcrc_raw)
    if hcrc != masked_crc32c(header):
        raise CorruptRecord(
            f"corrupt record header (crc mismatch) in {path!r} at offset "
            f"{offset}", path=path, offset=offset, resumable=False)
    payload = f.read(length)
    if len(payload) < length:
        raise CorruptRecord(
            f"truncated record payload in {path!r} at offset {offset} "
            f"(frame declares {length} bytes, file holds {len(payload)})",
            path=path, offset=offset)
    pcrc_raw = f.read(4)
    if len(pcrc_raw) < 4:
        raise CorruptRecord(f"truncated record payload crc in {path!r} at "
                            f"offset {offset}", path=path, offset=offset)
    (pcrc,) = struct.unpack("<I", pcrc_raw)
    # chaos mutates the payload before the check, as bit rot would
    payload = chaos.transform("data.record", payload)
    if pcrc != masked_crc32c(payload):
        raise CorruptRecord(
            f"corrupt record payload (crc mismatch) in {path!r} at offset "
            f"{offset}", path=path, offset=offset)
    return payload


class _PyRecordWriter:
    """``native.NativeRecordWriter``'s interface, in Python."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        write_record_bytes(self._f, payload)

    def close(self) -> None:
        self._f.close()


class _PyRecordReader:
    """``native.NativeRecordReader``'s interface, in Python."""

    def __init__(self, path: str):
        self._path = path
        self._f = open(path, "rb")

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        try:
            return read_record_bytes(self._f, path=self._path)
        except EOFError:
            raise StopIteration

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path: str, records: Iterable[Any],
                  shards: int = 1) -> List[str]:
    """Pickle ``records`` round-robin into ``shards`` files
    (``path-00000-of-00008``; ``path`` itself for one shard), each written
    under ``.tmp`` and renamed when complete."""
    from . import native

    if shards == 1:
        paths = [path]
    else:
        paths = [f"{path}-{i:05d}-of-{shards:05d}" for i in range(shards)]
    writer = (native.NativeRecordWriter if native.is_native_loaded()
              else _PyRecordWriter)
    files = [writer(p + ".tmp") for p in paths]
    try:
        for i, rec in enumerate(records):
            files[i % shards].write(pickle.dumps(rec, pickle.HIGHEST_PROTOCOL))
    finally:
        for fh in files:
            fh.close()
    for p in paths:
        os.replace(p + ".tmp", p)
    return paths


def shard_paths(path: str) -> List[str]:
    """One shard file, a glob pattern, or a base written with shards > 1,
    as sorted shard paths."""
    paths = sorted(glob.glob(path)) or sorted(glob.glob(path + "-*-of-*"))
    if not paths and os.path.exists(path):
        paths = [path]
    if not paths:
        raise FileNotFoundError(path)
    return paths


def read_records(path: str, skip: Optional[SkipBudget] = None
                 ) -> Iterator[Any]:
    """The records of one shard, a glob or a sharded base, shard by shard
    in file order (through the compiled reader unless ``skip`` has a
    budget or ``data.record`` is armed).  With ``skip``, resumable corrupt
    records (a payload CRC, a truncation, an unpicklable payload) are
    quarantined until its budget is spent."""
    from . import native

    use_native = (native.is_native_loaded()
                  and (skip is None or skip.budget <= 0)
                  and not chaos.armed("data.record"))
    opener = native.NativeRecordReader if use_native else _PyRecordReader
    for p in shard_paths(path):
        with opener(p) as reader:
            it = iter(reader)
            while True:
                try:
                    payload = next(it)
                except StopIteration:
                    break
                except CorruptRecord as e:
                    if skip is not None and skip.quarantine(e):
                        continue
                    raise
                try:
                    rec = loads(payload)
                except ReferenceGlobalError:
                    raise
                except Exception as e:  # noqa: BLE001 - a torn payload
                    ce = CorruptRecord(
                        f"unreadable record payload in {p!r} "
                        f"({type(e).__name__}: {e})", path=p)
                    if skip is not None and skip.quarantine(ce):
                        continue
                    raise ce from e
                yield rec


def count_records(path: str) -> int:
    """Records in one shard, by walking the frame headers (no CRC check,
    no unpickling)."""
    n = 0
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if not hdr:
                return n
            if len(hdr) < 8:
                raise IOError(f"truncated record header in {path!r}")
            (length,) = struct.unpack("<Q", hdr)
            f.seek(4 + length + 4, 1)
            n += 1
