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
  and an atomic rename publishes it;
- or, for a path with another scheme, through the filesystem registered
  for it (:func:`register_filesystem`) or fsspec's (imported only then):
  the framed bytes are written and read back, a mismatch is written again.
  Every op on such a store goes through :class:`RetryingFileSystem`:
  :class:`RetryPolicy`'s exponential backoff with deterministic jitter and
  a deadline (``BIGDL_TORCH_IO_RETRIES``, ``_IO_BACKOFF_BASE``,
  ``_IO_BACKOFF_MAX``, ``_IO_DEADLINE``; the clock and sleep injectable,
  :func:`set_retry_timebase`), so a transient store fault never reaches
  the Optimizer's retry budget.

:func:`load` and :func:`verify` check the frame and raise
:class:`CorruptCheckpoint` on truncation, a CRC mismatch or an unreadable
payload; a file without the magic loads as a legacy unframed pickle.  The
lineage helpers (:func:`checkpoint_lineage`, :func:`latest_checkpoint`,
:func:`quarantine_checkpoint`, :func:`prune_checkpoints`) are the
reference's.  :func:`save_checkpoint_async` pickles and writes a pair on
one background thread (at most two pending); :func:`join_checkpoints` and
:func:`wait_for_async_checkpoints` re-raise a write's error.  Fault points
(``utils/chaos.py``): ``ckpt.write`` and ``ckpt.read`` around every blob,
``fs.remote`` around every attempt of a remote op.

Release publication (``serve/continuous.py``) reads a snapshot's
integrity footer alone with :func:`frame_fingerprint` and follows a
lineage directory with :func:`watch_lineage`.  Not ported yet:
``sweep_numbered``, which elastic training and the serving fleet call
(ROADMAP queue A items 5 and 6).
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import struct
import time
from typing import Any, Dict, Optional, Tuple

import torch

from . import chaos, config
from .crc32c import crc32c_update

logger = logging.getLogger("bigdl_torch")

__all__ = ["save", "load", "verify", "save_checkpoint", "latest_checkpoint",
           "File", "register_filesystem", "get_filesystem",
           "CorruptCheckpoint", "checkpoint_lineage", "quarantine_checkpoint",
           "prune_checkpoints", "LocalFileSystem", "FsspecFileSystem",
           "RetryingFileSystem", "RetryPolicy", "set_retry_timebase",
           "save_checkpoint_async", "join_checkpoints",
           "wait_for_async_checkpoints", "frame_fingerprint",
           "watch_lineage"]

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


def frame_bytes(payload: bytes) -> bytes:
    """The payload and its integrity footer."""
    return payload + _footer(len(payload), _mask(crc32c_update(0, payload)))


def unframe_bytes(data: bytes, path: str = "<bytes>") -> bytes:
    """Check and strip the footer; raises :class:`CorruptCheckpoint` on a
    mismatch.  Data without the magic passes as it is (a legacy unframed
    pickle)."""
    if len(data) < _FOOTER_LEN or data[-len(_FRAME_MAGIC):] != _FRAME_MAGIC:
        return data
    length, crc = _FOOTER.unpack(data[-_FOOTER_LEN:-len(_FRAME_MAGIC)])
    payload = data[:-_FOOTER_LEN]
    if length != len(payload):
        raise CorruptCheckpoint(
            f"{path}: truncated checkpoint (frame declares {length} payload "
            f"bytes, file holds {len(payload)})")
    got = _mask(crc32c_update(0, payload))
    if got != crc:
        raise CorruptCheckpoint(
            f"{path}: checkpoint CRC mismatch (stored {crc:#010x}, "
            f"computed {got:#010x})")
    return payload


def _loads_payload(payload: bytes, path: str):
    try:
        return pickle.loads(payload)
    except Exception as e:  # noqa: BLE001 - any unpickle error is corrupt
        raise CorruptCheckpoint(f"{path}: unreadable payload "
                                f"({type(e).__name__}: {e})") from e


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
# retry and backoff for remote IO
# ---------------------------------------------------------------------------

# injectable time base: tests run backoff schedules without sleeping
_TIMEBASE = {"clock": time.monotonic, "sleep": time.sleep}


def set_retry_timebase(clock=None, sleep=None):
    """Swap the clock and sleep of the retry layer (tests); None is real
    time.  Returns the previous (clock, sleep)."""
    prev = (_TIMEBASE["clock"], _TIMEBASE["sleep"])
    _TIMEBASE["clock"] = clock or time.monotonic
    _TIMEBASE["sleep"] = sleep or time.sleep
    return prev


class RetryPolicy:
    """Exponential backoff with deterministic jitter and a deadline.  The
    jitter is a function of the attempt number alone (a golden-ratio hash
    into [0.5, 1]), so retries spread out without an RNG and chaos runs
    repeat exactly."""

    def __init__(self, retries: Optional[int] = None,
                 base: Optional[float] = None,
                 max_delay: Optional[float] = None,
                 deadline: Optional[float] = None,
                 clock=None, sleep=None):
        self.retries = (config.get_int("IO_RETRIES", 3)
                        if retries is None else retries)
        self.base = (config.get_float("IO_BACKOFF_BASE", 0.05)
                     if base is None else base)
        self.max_delay = (config.get_float("IO_BACKOFF_MAX", 2.0)
                          if max_delay is None else max_delay)
        self.deadline = (config.get_float("IO_DEADLINE", 60.0)
                         if deadline is None else deadline)
        self.clock = clock or _TIMEBASE["clock"]
        self.sleep = sleep or _TIMEBASE["sleep"]

    def delay(self, attempt: int) -> float:
        """The wait before retry ``attempt`` (1-based)."""
        d = min(self.base * (2 ** (attempt - 1)), self.max_delay)
        frac = (attempt * 0.6180339887498949) % 1.0
        return d * (0.5 + 0.5 * frac)

    def run(self, fn, describe: str = "", retriable=None):
        """``fn()`` with retries.  ``retriable(exc)`` says which errors get
        another attempt (default: any but :class:`CorruptCheckpoint`,
        which needs a rewrite, not a reread)."""
        start = self.clock()
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - filtered below
                ok = (retriable(e) if retriable is not None
                      else not isinstance(e, CorruptCheckpoint))
                attempt += 1
                if not ok or attempt > self.retries:
                    raise
                d = self.delay(attempt)
                if self.clock() - start + d > self.deadline:
                    logger.warning("remote IO %s: deadline %.1fs exhausted "
                                   "after %d attempts", describe,
                                   self.deadline, attempt)
                    raise
                logger.warning("remote IO %s failed (%s: %s); retry %d/%d "
                               "in %.2fs", describe, type(e).__name__, e,
                               attempt, self.retries, d)
                self.sleep(d)


# ---------------------------------------------------------------------------
# filesystems
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

    def write_bytes(self, path: str, data: bytes) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

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


class FsspecFileSystem:
    """A remote store through fsspec (gs://, s3://, hdfs://, memory://,
    ...).  fsspec is imported here, when a path with such a scheme is
    first used, never at import."""

    def __init__(self, scheme: str):
        import fsspec
        self.scheme = scheme
        self._fs = fsspec.filesystem(scheme)

    def write_bytes(self, path: str, data: bytes) -> None:
        parent = path.rsplit("/", 1)[0]
        if parent and parent != path:
            self.makedirs(parent)
        with self._fs.open(path, "wb") as f:
            f.write(data)

    def read_bytes(self, path: str) -> bytes:
        with self._fs.open(path, "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def isdir(self, path: str) -> bool:
        try:
            return self._fs.isdir(path)
        except Exception:  # noqa: BLE001
            return False

    def listdir(self, path: str):
        return [p.rsplit("/", 1)[-1] for p in self._fs.ls(path, detail=False)]

    def makedirs(self, path: str) -> None:
        try:
            self._fs.makedirs(path, exist_ok=True)
        except Exception:  # noqa: BLE001 - flat stores have no dirs
            pass

    def rename(self, src: str, dst: str) -> None:
        try:
            self._fs.mv(src, dst)
        except (AttributeError, NotImplementedError):
            # a flat store without a rename: copy, then delete
            self.write_bytes(dst, self.read_bytes(src))
            self._fs.rm(src)

    def remove(self, path: str) -> None:
        self._fs.rm(path)


class RetryingFileSystem:
    """The backoff layer of a non-local filesystem: every attempt of an op
    runs under :class:`RetryPolicy` and fires the ``fs.remote`` chaos
    point, so a transient store fault is absorbed here, below the
    Optimizer's retry loop, and never spends its budget."""

    _OPS = ("write_bytes", "read_bytes", "exists", "isdir", "listdir",
            "makedirs", "rename", "remove")

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        target = getattr(self.inner, name)
        if name not in self._OPS:
            return target

        def op(*args, **kwargs):
            def once():
                chaos.fire("fs.remote")
                return target(*args, **kwargs)
            describe = f"{name}({args[0] if args else ''!s:.120})"
            return RetryPolicy().run(once, describe=describe)
        return op


_REGISTRY: Dict[str, Any] = {}
_LOCAL = LocalFileSystem()


def register_filesystem(scheme: str, fs) -> None:
    """Install the filesystem of a URL scheme (an in-memory store in
    tests); a non-local one is wrapped in :class:`RetryingFileSystem`."""
    _REGISTRY[scheme] = fs if isinstance(
        fs, (LocalFileSystem, RetryingFileSystem)) else RetryingFileSystem(fs)


def get_filesystem(path: str):
    """The filesystem of ``path`` by its scheme (File.scala:106): plain
    paths and ``file://`` are local; another scheme takes the registered
    filesystem, else fsspec's, both behind the retry layer."""
    m = _SCHEME_RE.match(path)
    if not m or m.group(1) == "file":
        return _LOCAL
    scheme = m.group(1)
    if scheme not in _REGISTRY:
        _REGISTRY[scheme] = RetryingFileSystem(FsspecFileSystem(scheme))
    return _REGISTRY[scheme]


def _join(base: str, name: str) -> str:
    if _SCHEME_RE.match(base):
        return base.rstrip("/") + "/" + name
    return os.path.join(base, name)


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
    """(File.scala:25 ``save``; another scheme: ``saveToHdfs:106``.)  The
    written file is integrity-framed; a remote write is read back and
    written again on a mismatch."""
    path = _strip_file_scheme(path)
    fs = get_filesystem(path)
    # exists() may be a remote round trip: only asked when it matters
    if not overwrite and fs.exists(path):
        raise FileExistsError(path)
    obj = _to_numpy(obj)
    if fs is _LOCAL and not chaos.armed("ckpt.write"):
        fs.write_pickle(path, obj)   # streamed, no whole-blob copy
        return
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    # chaos mutates the framed bytes: a corrupt@ schedule lands a file
    # whose verification fails when it is read
    data = chaos.transform("ckpt.write", frame_bytes(payload))
    if fs is _LOCAL:
        fs.write_bytes(path, data)
        return

    def write_and_verify():
        fs.write_bytes(path, data)
        back = fs.read_bytes(path)
        if back != data:
            raise CorruptCheckpoint(
                f"{path}: remote readback mismatch (wrote {len(data)} "
                f"bytes, read {len(back)} back)")
    # a readback mismatch is retried: the fix is another write
    RetryPolicy().run(write_and_verify, describe=f"save({path})",
                      retriable=lambda e: True)


def load(path: str) -> Any:
    """(File.scala ``load``; another scheme: ``loadFromHdfs:139``.)
    Verifies the integrity frame; raises :class:`CorruptCheckpoint` on a
    CRC mismatch, truncation or an unreadable payload.  Numpy leaves stay
    numpy."""
    path = _strip_file_scheme(path)
    fs = get_filesystem(path)
    if fs is _LOCAL and not chaos.armed("ckpt.read"):
        return fs.read_pickle(path)
    data = chaos.transform("ckpt.read", fs.read_bytes(path))
    return _loads_payload(unframe_bytes(data, path), path)


def verify(path: str) -> None:
    """Integrity-check one blob without unpickling it: raises
    :class:`CorruptCheckpoint` on a CRC mismatch or truncation."""
    path = _strip_file_scheme(path)
    fs = get_filesystem(path)
    if fs is _LOCAL:
        with open(path, "rb") as f:   # chunked, no whole-blob copy
            LocalFileSystem._verify_frame(f, path)
        return
    unframe_bytes(fs.read_bytes(path), path)


def save_checkpoint(path: str, neval: int, model_blob: Any,
                    optim_blob: Any, overwrite: bool = True) -> Tuple[str, str]:
    """Write ``model.<neval>`` and ``optimMethod.<neval>``
    (DistriOptimizer.scala:394-416); returns their paths."""
    path = _strip_file_scheme(path)
    get_filesystem(path).makedirs(path)
    mp = _join(path, f"model.{neval}")
    op = _join(path, f"optimMethod.{neval}")
    save(model_blob, mp, overwrite)
    save(optim_blob, op, overwrite)
    return mp, op


_ASYNC_EXECUTOR = None
_ASYNC_FUTURES: list = []


def save_checkpoint_async(path: str, neval: int, model_blob: Any,
                          optim_blob: Any, overwrite: bool = True,
                          ready=None):
    """:func:`save_checkpoint` on one background writer thread (pairs land
    in the order they were handed in); returns its future.  The blobs must
    already be host data that nothing will change: torch tensors are
    copied to numpy here.  ``ready`` (a CUDA event) is waited on before
    the pickle, for blobs that view pinned memory a device copy is still
    filling.  At most two writes are pending: a third waits for the oldest
    and raises its error here.  Otherwise errors surface at
    :func:`join_checkpoints` or :func:`wait_for_async_checkpoints`."""
    global _ASYNC_EXECUTOR
    model_blob = _to_numpy(model_blob)
    optim_blob = _to_numpy(optim_blob)
    if _ASYNC_EXECUTOR is None:
        from concurrent.futures import ThreadPoolExecutor
        _ASYNC_EXECUTOR = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="bigdl-torch-ckpt")
    _ASYNC_FUTURES[:] = [f for f in _ASYNC_FUTURES if not f.done()]
    while len(_ASYNC_FUTURES) >= 2:
        _ASYNC_FUTURES.pop(0).result()

    def write():
        if ready is not None:
            ready.synchronize()
        return save_checkpoint(path, neval, model_blob, optim_blob,
                               overwrite)
    fut = _ASYNC_EXECUTOR.submit(write)
    _ASYNC_FUTURES.append(fut)
    return fut


def join_checkpoints(futures) -> None:
    """Join every future, then re-raise the first error."""
    first_err = None
    for f in futures:
        try:
            f.result()
        except Exception as e:  # noqa: BLE001 - re-raised below
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def wait_for_async_checkpoints() -> None:
    """Block until every pending asynchronous pair is written; re-raises
    the first write error (after joining them all)."""
    global _ASYNC_FUTURES
    futs, _ASYNC_FUTURES = _ASYNC_FUTURES, []
    join_checkpoints(futs)


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
    return [(_join(path, f"model.{n}"), _join(path, f"optimMethod.{n}"), n)
            for n in nevals if f"optimMethod.{n}" in names]


def latest_checkpoint(path: str) -> Optional[Tuple[str, str, int]]:
    """The newest (model, optimMethod, neval) triple
    (getLatestFile, DistriOptimizer.scala:828-845), or None."""
    lineage = checkpoint_lineage(path)
    return lineage[0] if lineage else None


def frame_fingerprint(path: str) -> Optional[Tuple[int, int]]:
    """A framed blob's ``(payload_length, masked_crc32c)`` read from its
    footer alone, without reading or checking the payload; None for a
    legacy unframed file.  A release entry pins it (``serve/continuous``)
    and the deploy controller compares it with the snapshot it is about to
    serve: a snapshot rewritten after publication no longer matches."""
    path = _strip_file_scheme(path)
    fs = get_filesystem(path)
    if isinstance(fs, LocalFileSystem):
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < _FOOTER_LEN:
                return None
            f.seek(size - _FOOTER_LEN)
            tail = f.read(_FOOTER_LEN)
    else:
        data = fs.read_bytes(path)
        if len(data) < _FOOTER_LEN:
            return None
        tail = data[-_FOOTER_LEN:]
    if tail[-len(_FRAME_MAGIC):] != _FRAME_MAGIC:
        return None
    length, crc = _FOOTER.unpack(tail[:_FOOTER.size])
    return int(length), int(crc)


def watch_lineage(path: str, since: int = -1, *,
                  pattern: str = r"model\.(\d+)",
                  poll: Optional[float] = None,
                  clock=None, sleep=None, stop=None,
                  idle_timeout: Optional[float] = None):
    """Follow a lineage directory on any scheme: a generator of ``(n,
    path)`` for every file under ``path`` whose name fullmatches
    ``pattern`` (group 1 the monotonic id), in id order, ids above
    ``since`` only, each at most once.  Quarantined (``*.corrupt``) and
    half-written (``*.tmp``) files never match.

    ``poll`` fixes the delay of an idle turn; None backs off as
    :class:`RetryPolicy` does (``BIGDL_TORCH_IO_BACKOFF_BASE`` up to
    ``_IO_BACKOFF_MAX``, deterministic jitter), from the start again once
    something new appears.  ``clock`` and ``sleep`` are injectable;
    ``stop`` is a callable checked every turn and between yields;
    ``idle_timeout`` ends the watch after that many seconds with nothing
    new.  A listing that fails is logged and read as empty."""
    path = _strip_file_scheme(path)
    matcher = re.compile(pattern)
    clk = clock or _TIMEBASE["clock"]
    slp = sleep or _TIMEBASE["sleep"]
    policy = RetryPolicy(clock=clk, sleep=slp)
    last = int(since)
    idle_since = None
    attempt = 0
    while True:
        if stop is not None and stop():
            return
        fs = get_filesystem(path)
        try:
            names = fs.listdir(path) if fs.isdir(path) else []
        except Exception as e:  # noqa: BLE001 - a transient listing
            # failure must not end the watch (remote ops are retried below
            # this; a directory not there yet is a trainer not started)
            logger.warning("watch_lineage(%s): listing failed (%s: %s); "
                           "treating as empty this poll", path,
                           type(e).__name__, e)
            names = []
        found = {}
        for name in names:
            m = matcher.fullmatch(name)
            if m:
                found[int(m.group(1))] = name
        fresh = sorted(n for n in found if n > last)
        if fresh:
            attempt = 0
            idle_since = None
            for n in fresh:
                last = n
                yield n, _join(path, found[n])
                if stop is not None and stop():
                    return
            continue
        now = clk()
        if idle_since is None:
            idle_since = now
        if idle_timeout is not None and now - idle_since >= idle_timeout:
            return
        attempt = min(attempt + 1, 12)  # cap the exponent, not the wait
        slp(poll if poll is not None else policy.delay(attempt))


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
