"""Checkpoint save and load in the reference's file format.

Counterpart of ``bigdl_tpu/utils/file_io.py`` (reference
``utils/File.scala:25``; the checkpoint contract ``model.<neval>`` /
``optimMethod.<neval>`` of ``optim/Optimizer.scala:284-322`` and
``DistriOptimizer.scala:394-416``).  The format is the reference's, byte
for byte, so each package reads the other's snapshots:

- a pickle (highest protocol) of dicts and lists of numpy leaves (torch
  tensors handed to :func:`save` become numpy first);
- followed by the integrity footer ``<u64 payload length> <u32 masked
  CRC32C> b"BGLNCKP1"``, the TFRecord-masked CRC32C of ``utils/crc32c.py``;
- written through :class:`LocalFileSystem`: the pickle streams to a
  ``.tmp`` file through a CRC tee (no whole-blob copy), the footer follows,
  and an atomic rename publishes it.

:func:`load` and :func:`verify` check the frame and raise
:class:`CorruptCheckpoint` on truncation, a CRC mismatch or an unreadable
payload; a file without the magic loads as a legacy unframed pickle.  The
lineage helpers (:func:`checkpoint_lineage`, :func:`latest_checkpoint`,
:func:`quarantine_checkpoint`, :func:`prune_checkpoints`) are the
reference's.

Not ported yet (ROADMAP queue A item 3): remote schemes (fsspec) and the
``RetryPolicy`` around them, asynchronous writes, release publication and
``watch_lineage``.  A path with a scheme other than ``file://`` raises.
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import struct
from typing import Any, Optional, Tuple

import torch

from .crc32c import crc32c_update

logger = logging.getLogger("bigdl_torch")

__all__ = ["save", "load", "verify", "save_checkpoint", "latest_checkpoint",
           "File", "get_filesystem", "CorruptCheckpoint",
           "checkpoint_lineage", "quarantine_checkpoint",
           "prune_checkpoints", "LocalFileSystem"]

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")


class CorruptCheckpoint(IOError):
    """A checkpoint whose integrity frame (or payload) failed verification.
    Lineage-walking resume catches exactly this type: it quarantines the
    file and falls back to the next-newest snapshot."""


# ---------------------------------------------------------------------------
# integrity frame: <payload> <u64 length> <u32 masked crc32c> <magic>
# ---------------------------------------------------------------------------

_FRAME_MAGIC = b"BGLNCKP1"  # 8 bytes, last in the file
_FOOTER = struct.Struct("<QI")
_FOOTER_LEN = _FOOTER.size + len(_FRAME_MAGIC)
_CRC_CHUNK = 4 << 20


def _mask(crc: int) -> int:
    """The TFRecord CRC mask."""
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _footer(length: int, masked_crc: int) -> bytes:
    return _FOOTER.pack(length, masked_crc) + _FRAME_MAGIC


class _CrcTee:
    """File-object shim: streams ``pickle.dump`` output to ``f`` while
    keeping a running CRC32C and byte count."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.nbytes = 0

    def write(self, data):
        # protocol-5 pickling hands buffer objects (PickleBuffer,
        # memoryview) to write(); normalize once for the crc and length
        data = bytes(data)
        self._f.write(data)
        self.crc = crc32c_update(self.crc, data)
        self.nbytes += len(data)


# ---------------------------------------------------------------------------
# the local filesystem
# ---------------------------------------------------------------------------

class LocalFileSystem:
    """Local files with atomic writes (tmp + rename)."""

    def write_pickle(self, path: str, obj) -> None:
        """Stream-pickle straight to disk, the CRC32C running alongside,
        then the footer and an atomic rename."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            tee = _CrcTee(f)
            pickle.dump(obj, tee, protocol=pickle.HIGHEST_PROTOCOL)
            f.write(_footer(tee.nbytes, _mask(tee.crc)))
        os.replace(tmp, path)

    def read_pickle(self, path: str):
        with open(path, "rb") as f:
            self._verify_frame(f, path)
            f.seek(0)
            try:
                # pickle.load stops at the STOP opcode: the footer is never
                # consumed
                return pickle.load(f)
            except Exception as e:  # noqa: BLE001 — any unpickle error
                raise CorruptCheckpoint(f"{path}: unreadable payload "
                                        f"({type(e).__name__}: {e})") from e

    @staticmethod
    def _verify_frame(f, path: str) -> None:
        """Chunked CRC verify of a framed file (a legacy unframed file
        passes)."""
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < _FOOTER_LEN:
            return
        f.seek(size - len(_FRAME_MAGIC))
        if f.read(len(_FRAME_MAGIC)) != _FRAME_MAGIC:
            return
        f.seek(size - _FOOTER_LEN)
        length, crc = _FOOTER.unpack(f.read(_FOOTER.size))
        payload_len = size - _FOOTER_LEN
        if length != payload_len:
            raise CorruptCheckpoint(
                f"{path}: truncated checkpoint (frame declares {length} "
                f"payload bytes, file holds {payload_len})")
        f.seek(0)
        got, left = 0, payload_len
        while left:
            chunk = f.read(min(_CRC_CHUNK, left))
            if not chunk:
                raise CorruptCheckpoint(f"{path}: short read during "
                                        "CRC verification")
            got = crc32c_update(got, chunk)
            left -= len(chunk)
        if _mask(got) != crc:
            raise CorruptCheckpoint(
                f"{path}: checkpoint CRC mismatch (stored {crc:#010x}, "
                f"computed {_mask(got):#010x})")

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def listdir(self, path: str):
        return os.listdir(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def remove(self, path: str) -> None:
        os.remove(path)


_LOCAL = LocalFileSystem()


def get_filesystem(path: str) -> LocalFileSystem:
    """The filesystem of ``path``: plain paths and ``file://`` are local;
    any other scheme raises."""
    m = _SCHEME_RE.match(path)
    if m and m.group(1) != "file":
        raise NotImplementedError(
            f"{m.group(1)}:// checkpoints: remote filesystems are not "
            "ported yet (ROADMAP queue A item 3)")
    return _LOCAL


def _strip_file_scheme(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


def _to_numpy(tree):
    """Torch tensors to numpy (bfloat16 widened to float32, exactly: numpy
    has no bfloat16), through dicts, lists and tuples; other leaves as they
    are."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def save(obj: Any, path: str, overwrite: bool = True) -> None:
    """(File.scala:25 ``save``.)  The written file is integrity-framed."""
    path = _strip_file_scheme(path)
    fs = get_filesystem(path)
    if not overwrite and fs.exists(path):
        raise FileExistsError(path)
    fs.write_pickle(path, _to_numpy(obj))


def load(path: str) -> Any:
    """(File.scala ``load``.)  Verifies the integrity frame; raises
    :class:`CorruptCheckpoint` on a CRC mismatch, truncation or an
    unreadable payload.  Numpy leaves stay numpy."""
    path = _strip_file_scheme(path)
    return get_filesystem(path).read_pickle(path)


def verify(path: str) -> None:
    """Integrity-check one blob without unpickling it: raises
    :class:`CorruptCheckpoint` on a CRC mismatch or truncation."""
    path = _strip_file_scheme(path)
    get_filesystem(path)
    with open(path, "rb") as f:
        LocalFileSystem._verify_frame(f, path)


def save_checkpoint(path: str, neval: int, model_blob: Any,
                    optim_blob: Any, overwrite: bool = True) -> Tuple[str, str]:
    """Write ``model.<neval>`` and ``optimMethod.<neval>``
    (DistriOptimizer.scala:394-416); returns their paths."""
    path = _strip_file_scheme(path)
    get_filesystem(path).makedirs(path)
    mp = os.path.join(path, f"model.{neval}")
    op = os.path.join(path, f"optimMethod.{neval}")
    save(model_blob, mp, overwrite)
    save(optim_blob, op, overwrite)
    return mp, op


# ---------------------------------------------------------------------------
# lineage: list, resume-by-latest, quarantine, retention
# ---------------------------------------------------------------------------

def checkpoint_lineage(path: str):
    """Every complete snapshot triple (model, optimMethod, neval) in
    ``path``, newest first.  Quarantined (``.corrupt``) files and a model
    without its optimMethod are left out."""
    path = _strip_file_scheme(path)
    fs = get_filesystem(path)
    if not fs.isdir(path):
        return []
    names = set(fs.listdir(path))
    nevals = sorted((int(m.group(1)) for m in
                     (re.fullmatch(r"model\.(\d+)", n) for n in names) if m),
                    reverse=True)
    return [(os.path.join(path, f"model.{n}"),
             os.path.join(path, f"optimMethod.{n}"), n)
            for n in nevals if f"optimMethod.{n}" in names]


def latest_checkpoint(path: str) -> Optional[Tuple[str, str, int]]:
    """The newest (model, optimMethod, neval) triple
    (getLatestFile, DistriOptimizer.scala:828-845), or None."""
    lineage = checkpoint_lineage(path)
    return lineage[0] if lineage else None


def quarantine_checkpoint(model_path: str,
                          optim_path: Optional[str] = None) -> None:
    """Rename a corrupt snapshot aside (``.corrupt``): it leaves the
    lineage but stays on disk to be looked at."""
    for p in (model_path, optim_path):
        if not p:
            continue
        p = _strip_file_scheme(p)
        fs = get_filesystem(p)
        try:
            if fs.exists(p):
                fs.rename(p, p + ".corrupt")
                logger.warning("quarantined corrupt checkpoint file %s -> "
                               "%s.corrupt", p, p)
        except OSError as e:
            # best effort: resume must go on to older snapshots
            logger.warning("could not quarantine %s: %s", p, e)


def prune_checkpoints(path: str, keep_last: int, keep=()) -> list:
    """Retention: delete the snapshot pairs beyond the newest
    ``keep_last``, except the nevals in ``keep``.  Quarantined files are
    never touched.  Returns the pruned nevals."""
    if keep_last <= 0:
        return []
    path = _strip_file_scheme(path)
    fs = get_filesystem(path)
    keep = set(keep)
    pruned = []
    for i, (mp, op, n) in enumerate(checkpoint_lineage(path)):
        if i < keep_last or n in keep:
            continue
        try:
            fs.remove(mp)
            fs.remove(op)
            pruned.append(n)
        except OSError as e:
            # retention is best effort: a failed delete never stops training
            logger.warning("retention: could not prune snapshot %d in %s: "
                           "%s", n, path, e)
    if pruned:
        logger.info("retention: pruned snapshots %s from %s (keep_last=%d, "
                    "keepers=%s)", sorted(pruned), path, keep_last,
                    sorted(keep))
    return pruned


class File:
    """Namespace parity with the reference's ``File`` object."""

    save = staticmethod(save)
    load = staticmethod(load)
