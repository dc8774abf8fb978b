"""Hadoop SequenceFile shards: the reference's ImageNet input format.

Counterpart of ``bigdl_tpu/dataset/seqfile.py``.  The reference reads
``.seq`` shards of (Text key, Text value) pairs
(``DataSet.SeqFileFolder.files``, dataset/DataSet.scala:319, :524-531),
written by ``BGRImgToLocalSeqFile`` (dataset/image/
BGRImgToLocalSeqFile.scala:53-70):

  key   = "<label>"  or  "<name>\\n<label>"   (readLabel: DataSet.scala:496)
  value = int32 width . int32 height . H*W*3 BGR uint8 pixels

The uncompressed SequenceFile v6 framing (a header with VInt-length class
names, metadata and a 16-byte sync marker; records as [recordLen][keyLen]
[key][value], a -1 record length escaping a sync marker) and Hadoop's
zero-compressed VInt are written out here, the same as the JAX package's,
so a file written by either package reads in the other:

  read_seq_file(path)        -> (key_bytes, value_bytes) pairs
  read_byte_records(path)    -> {"data": HxWx3 uint8 BGR, "label": float}
  write_seq_file(path, ...)  -> the same wire format
  SeqFileDataSet             -> StreamingRecordDataSet over .seq shards

A compressed file raises, naming its codec.  A record that fails its
checks (a value too short for its pixels, a label that does not parse)
raises :class:`~bigdl_torch.utils.recordio.CorruptRecord` with its path
and offset; ``read_byte_records(skip=...)`` quarantines such records up to
a budget.  A bad sync marker or key length stays fatal whatever the
budget: the stream cannot be resynchronized past it.  The ``data.record``
chaos point mutates value bytes before the checks.
"""

from __future__ import annotations

import glob as _glob
import io
import os
import struct
from typing import Iterator, List, Tuple

import numpy as np

from . import StreamingRecordDataSet
from .image import LabeledImage
from ..utils import chaos
from ..utils.recordio import CorruptRecord, SkipBudget

__all__ = ["read_seq_file", "read_byte_records", "write_seq_file",
           "count_seq_records", "find_seq_files", "SeqFileDataSet",
           "seq_file_folder"]


def find_seq_files(folder: str) -> List[str]:
    """Every `*.seq` under `folder`, sorted (SeqFileFolder.findFiles sorts
    lexically, DataSet.scala:551)."""
    paths = sorted(_glob.glob(os.path.join(folder, "*.seq")))
    if not paths:
        raise FileNotFoundError(f"no .seq files under {folder!r}")
    return paths

_VERSION = 6
_SYNC_ESCAPE = -1
_TEXT = "org.apache.hadoop.io.Text"


# -- Hadoop zero-compressed VInt (WritableUtils.writeVLong) -----------------

def _read_vint(f) -> int:
    first = struct.unpack(">b", f.read(1))[0]
    if first >= -112:
        return first
    negative = first < -120
    n = (-first - 120) if negative else (-first - 112)
    val = int.from_bytes(f.read(n), "big")
    return ~val if negative else val


def _write_vint(f, i: int) -> None:
    if -112 <= i <= 127:
        f.write(struct.pack(">b", i))
        return
    length = -112
    if i < 0:
        i = ~i
        length = -120
    tmp = i
    while tmp:
        tmp >>= 8
        length -= 1
    f.write(struct.pack(">b", length))
    n = (-length - 120) if length < -120 else (-length - 112)
    f.write(i.to_bytes(n, "big"))


def _read_text(f) -> bytes:
    return f.read(_read_vint(f))


def _write_text(f, data: bytes) -> None:
    _write_vint(f, len(data))
    f.write(data)


# -- framing ----------------------------------------------------------------

def _read_header(f) -> Tuple[str, str, bytes]:
    magic = f.read(4)
    if magic[:3] != b"SEQ":
        raise ValueError("not a Hadoop SequenceFile (missing SEQ magic)")
    if magic[3] != _VERSION:
        raise ValueError(f"SequenceFile version {magic[3]} unsupported "
                         f"(expected {_VERSION})")
    key_cls = _read_text(f).decode()
    val_cls = _read_text(f).decode()
    compressed = f.read(1)[0] != 0
    block_compressed = f.read(1)[0] != 0
    if compressed or block_compressed:
        codec = _read_text(f).decode() if compressed else "block"
        raise ValueError(f"compressed SequenceFile unsupported (codec "
                         f"{codec}); the reference's generator writes "
                         "uncompressed files")
    n_meta = struct.unpack(">i", f.read(4))[0]
    for _ in range(n_meta):
        _read_text(f)
        _read_text(f)
    sync = f.read(16)
    return key_cls, val_cls, sync


def _iter_records(path: str, keys_only: bool):
    """Yield (key, value, record_byte_offset) triples.  Framing errors
    (sync marker, keyLen) raise a non-resumable CorruptRecord — the
    length fields themselves are untrusted, resync is impossible, so no
    skip budget applies to them."""
    with open(path, "rb") as f:
        _key_cls, _val_cls, sync = _read_header(f)
        while True:
            offset = f.tell()
            raw = f.read(4)
            if len(raw) < 4:
                return
            rec_len = struct.unpack(">i", raw)[0]
            if rec_len == _SYNC_ESCAPE:
                marker = f.read(16)
                if marker != sync:
                    raise CorruptRecord(f"{path}: corrupt sync marker at "
                                        f"offset {offset}", path=path,
                                        offset=offset, resumable=False)
                continue
            key_len = struct.unpack(">i", f.read(4))[0]
            if key_len < 0 or key_len > rec_len:
                # f.read(negative) would silently slurp the rest of the
                # file into one value — corrupt shards must fail loudly
                raise CorruptRecord(
                    f"{path}: corrupt record at offset {offset} (keyLen "
                    f"{key_len} vs recordLen {rec_len})", path=path,
                    offset=offset, resumable=False)
            key = f.read(key_len)
            if keys_only:  # label walks skip the pixel payload entirely
                f.seek(rec_len - key_len, os.SEEK_CUR)
                yield _read_text(io.BytesIO(key)), None, offset
                continue
            value = f.read(rec_len - key_len)
            # chaos mutates the raw value BEFORE the vint strip +
            # structural validation downstream (truncate = a torn shard)
            value = chaos.transform("data.record", value)
            # both are Text: strip the vint length prefixes
            try:
                yield (_read_text(io.BytesIO(key)),
                       _read_text(io.BytesIO(value)), offset)
            except Exception as e:  # noqa: BLE001 — a torn vint header
                raise CorruptRecord(
                    f"{path}: corrupt Text payload at offset {offset} "
                    f"({type(e).__name__}: {e})", path=path,
                    offset=offset) from e


def read_seq_file(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield raw (key, value) payloads (Text vint headers stripped)."""
    return ((k, v) for k, v, _off in _iter_records(path, keys_only=False))


def iter_seq_keys(path: str) -> Iterator[bytes]:
    """Key-only walk: seeks past every value, so counting/label scans never
    pull the pixel payload through Python."""
    return (k for k, _v, _off in _iter_records(path, keys_only=True))


def _parse_label(key: bytes) -> float:
    """DataSet.scala:496 readLabel: one line = label; two = name\\nlabel."""
    parts = key.decode("utf-8", errors="replace").split("\n")
    return float(parts[0] if len(parts) == 1 else parts[1])


def read_byte_records(path: str, class_num: int = None,
                      skip: SkipBudget = None) -> Iterator[dict]:
    """Decode the generator's value layout into BDRecord-style dicts:
    {"data": (H, W, 3) uint8 BGR, "label": float} — ByteRecord semantics
    (the label filter mirrors `.filter(_.label <= classNum)`).

    Record values are structurally validated (SequenceFiles carry no
    CRC): a value too short for its declared w x h x 3 pixels, absurd
    dimensions, or an unparseable label raise :class:`CorruptRecord`.
    `skip` (a SkipBudget) quarantines such records — offset + reason
    logged, counted — up to its budget instead of killing the pass."""
    for key, value, offset in _iter_records(path, keys_only=False):
        try:
            try:
                label = _parse_label(key)
            except ValueError as e:
                raise CorruptRecord(
                    f"{path}: unparseable record label at offset {offset} "
                    f"({e})", path=path, offset=offset) from e
            if class_num is not None and label > class_num:
                continue
            if len(value) < 8:
                raise CorruptRecord(
                    f"{path}: short image record at offset {offset} "
                    f"({len(value)} value bytes)", path=path, offset=offset)
            w, h = struct.unpack(">ii", value[:8])
            if w <= 0 or h <= 0 or 8 + w * h * 3 > len(value):
                raise CorruptRecord(
                    f"{path}: corrupt image record at offset {offset} "
                    f"(w={w}, h={h} vs {len(value)} value bytes)",
                    path=path, offset=offset)
            pixels = np.frombuffer(value[8:8 + w * h * 3], np.uint8)
            yield {"data": pixels.reshape(h, w, 3), "label": label}
        except CorruptRecord as e:
            if skip is not None and skip.quarantine(e):
                continue
            raise


def count_seq_records(path: str) -> int:
    """Header walk (no pixel decode), for the streaming dataset's caps."""
    n = 0
    with open(path, "rb") as f:
        _k, _v, sync = _read_header(f)
        while True:
            raw = f.read(4)
            if len(raw) < 4:
                return n
            rec_len = struct.unpack(">i", raw)[0]
            if rec_len == _SYNC_ESCAPE:
                f.seek(16, os.SEEK_CUR)
                continue
            f.seek(4 + rec_len, os.SEEK_CUR)  # keyLen field + key + value
            n += 1


def write_seq_file(path: str, records, sync_interval: int = 5) -> str:
    """Write (label, HxWx3 uint8 image) pairs in the generator's format
    (BGRImgToLocalSeqFile.scala:53-70).  `records` yields (label, img) or
    (name, label, img).  Sync markers every `sync_interval` records keep
    the escape path honest in tests (Hadoop writes them by byte count)."""
    sync = os.urandom(16)
    with open(path, "wb") as f:
        f.write(b"SEQ" + bytes([_VERSION]))
        _write_text(f, _TEXT.encode())
        _write_text(f, _TEXT.encode())
        f.write(b"\x00\x00")                   # no (block) compression
        f.write(struct.pack(">i", 0))          # empty metadata
        f.write(sync)
        for i, rec in enumerate(records):
            if len(rec) == 3:
                name, label, img = rec
                key = f"{name}\n{int(label)}".encode()
            else:
                label, img = rec
                key = str(int(label)).encode()
            img = np.ascontiguousarray(img, np.uint8)
            h, w = img.shape[:2]
            value = struct.pack(">ii", w, h) + img.tobytes()
            kb = io.BytesIO()
            _write_text(kb, key)
            vb = io.BytesIO()
            _write_text(vb, value)
            kbytes, vbytes = kb.getvalue(), vb.getvalue()
            if i and i % sync_interval == 0:
                f.write(struct.pack(">i", _SYNC_ESCAPE))
                f.write(sync)
            f.write(struct.pack(">ii", len(kbytes) + len(vbytes),
                                len(kbytes)))
            f.write(kbytes)
            f.write(vbytes)
    return path


class SeqFileDataSet(StreamingRecordDataSet):
    """Out-of-core streaming over `.seq` shards: inherits the shard-order
    shuffle, rank-strided distribution and equal-step capping from
    StreamingRecordDataSet, swapping the record codec for the SequenceFile
    framing.  Records surface as `LabeledImage` (float32 BGR in [0,255]),
    exactly what the dataset/image.py transformer chain consumes — the
    reference's SeqFileFolder -> BytesToBGRImg pipeline shape:

        DataSet.seq_file_folder(dir).transform(ImgNormalizer(m, s))
            .transform(ImgToSample()).transform(SampleToMiniBatch(b))
    """

    def __init__(self, paths, class_num: int = None, **kw):
        kw.pop("num_threads", None)  # native BDRecord prefetcher N/A here
        super().__init__(paths, **kw)
        self.class_num = class_num

    def _shard_counts(self):
        if self._counts is None:
            if self.class_num is None:
                self._counts = [count_seq_records(p) for p in self.paths]
            else:
                # the filter changes per-shard record counts, and the
                # distributed equal-step cap (and size()) must see the
                # FILTERED counts or ranks would take unequal step counts
                # into the per-step collectives; the key-only walk seeks
                # past every pixel payload
                self._counts = [
                    sum(1 for k in iter_seq_keys(p)
                        if _parse_label(k) <= self.class_num)
                    for p in self.paths]
        return self._counts

    def _read_shard(self, path, skip=None):
        for rec in read_byte_records(path, self.class_num, skip=skip):
            yield LabeledImage(rec["data"].astype(np.float32),
                               float(rec["label"]))


def seq_file_folder(folder: str, class_num: int = None,
                    distributed: bool = False, **kw) -> SeqFileDataSet:
    """`DataSet.seq_file_folder` backend (see find_seq_files)."""
    return SeqFileDataSet(find_seq_files(folder), class_num=class_num,
                          distributed=distributed, **kw)
