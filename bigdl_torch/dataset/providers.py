"""Dataset providers: parsers of the standard benchmark files.

Counterpart of ``bigdl_tpu/dataset/providers.py`` (reference
``pyspark/bigdl/dataset/{mnist,news20,movielens}.py``): local copies of
MNIST's idx files (gzipped or not), CIFAR-10's binary batches,
news20-style labeled text directories (or their tarball) and MovieLens
ratings become ``Sample`` lists (or arrays) for ``DataSet.array``.
:func:`fetch_file` takes the reference's ``maybe_download`` role: it copies
a file from any ``utils/file_io`` scheme (``memory://`` in tests; every
remote op already retried there) to a local path, verifies its size and
sha256, fetches again on a mismatch and writes atomically.
"""

from __future__ import annotations

import glob
import gzip
import hashlib
import logging
import os
import struct
import tarfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from .sample import Sample

logger = logging.getLogger("bigdl_torch")

__all__ = ["load_mnist", "load_cifar10_binary", "load_labeled_text_dir",
           "load_movielens", "fetch_file", "DownloadIntegrityError"]


class DownloadIntegrityError(IOError):
    """A fetched file failed size/checksum verification after every
    retry — the transfer is torn or the source is wrong, and feeding it
    into training would corrupt the run silently."""


def fetch_file(url: str, dest: str, expected_size: Optional[int] = None,
               expected_sha256: Optional[str] = None) -> str:
    """Download `url` to local `dest` (the reference's
    dataset/base.py `maybe_download` role, rebuilt on file_io).

    - Any `file_io` scheme works (``gs://``/``s3://``/``hdfs://``/
      ``memory://``...); each remote op already runs under file_io's
      retry/backoff layer (``BIGDL_TORCH_IO_*`` knobs), so a transient
      storage blip never surfaces here.
    - `expected_size` / `expected_sha256` verify the WHOLE transfer; a
      mismatch (torn read, wrong object) re-fetches under the same
      RetryPolicy and finally raises :class:`DownloadIntegrityError`.
    - An existing `dest` that passes verification is reused — no
      re-download (maybe_download semantics).
    - The local write is atomic (tmp + rename): a crash mid-fetch never
      leaves a half file that a later call would trust.
    """
    from ..utils import file_io

    def verify(data: bytes) -> None:
        if expected_size is not None and len(data) != expected_size:
            raise DownloadIntegrityError(
                f"{url}: size mismatch (expected {expected_size} bytes, "
                f"got {len(data)})")
        if expected_sha256 is not None:
            got = hashlib.sha256(data).hexdigest()
            if got != expected_sha256.lower():
                raise DownloadIntegrityError(
                    f"{url}: sha256 mismatch (expected {expected_sha256}, "
                    f"got {got})")

    if os.path.exists(dest):
        with open(dest, "rb") as f:
            data = f.read()
        try:
            verify(data)
            return dest  # cached copy verified: no re-download
        except DownloadIntegrityError as e:
            logger.warning("fetch_file: cached %s failed verification "
                           "(%s); re-fetching", dest, e)

    fs = file_io.get_filesystem(url)

    def fetch_once():
        data = fs.read_bytes(url)
        verify(data)
        d = os.path.dirname(dest)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = dest + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, dest)

    # integrity failures ARE retriable here: the fix is another fetch
    # (fs.read_bytes itself already retried transient remote errors)
    file_io.RetryPolicy().run(
        fetch_once, describe=f"fetch({url})",
        retriable=lambda e: isinstance(e, DownloadIntegrityError))
    logger.info("fetch_file: %s -> %s (%d bytes%s)", url, dest,
                os.path.getsize(dest),
                ", sha256 verified" if expected_sha256 else "")
    return dest


#: the standard MNIST idx.gz artifact names (mnist.py read_data_sets)
_MNIST_FILES = {
    "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
    "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
}


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (the MNIST container format; mnist.py:33-74)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
                  0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"),
                  0x0E: np.dtype(">f8")}
        if dtype_code not in dtypes:
            raise ValueError(f"bad IDX magic {magic:#x} in {path}")
        data = np.frombuffer(f.read(), dtype=dtypes[dtype_code])
    return data.reshape(dims)


def load_mnist(directory: str, data_type: str = "train",
               normalize: bool = True, source: Optional[str] = None,
               checksums: Optional[Dict[str, str]] = None) -> List[Sample]:
    """MNIST from the standard idx(.gz) pairs in `directory`
    (mnist.py:76 read_data_sets role).  Returns Samples with (28,28,1)
    float features and int labels.

    `source` (a file_io URL base, e.g. ``gs://bucket/mnist``) fetches any
    missing standard file through :func:`fetch_file` — retried/backed-off
    remote IO with optional per-file sha256 verification via `checksums`
    (filename -> hex digest)."""
    prefix = "train" if data_type == "train" else "t10k"
    if source:
        for name in _MNIST_FILES["train" if data_type == "train"
                                 else "test"]:
            dest = os.path.join(directory, name)
            if not os.path.exists(dest):
                fetch_file(source.rstrip("/") + "/" + name, dest,
                           expected_sha256=(checksums or {}).get(name))
    def find(kind):
        for pat in (f"{prefix}-{kind}-idx?-ubyte", f"{prefix}-{kind}*ubyte*"):
            hits = sorted(glob.glob(os.path.join(directory, pat)))
            if hits:
                return hits[0]
        raise FileNotFoundError(
            f"no {prefix} {kind} idx file under {directory}")
    images = _read_idx(find("images")).astype(np.float32)[..., None]
    labels = _read_idx(find("labels")).astype(np.int32)
    if normalize:
        images /= 255.0
    return [Sample(images[i], labels[i]) for i in range(len(labels))]


def load_cifar10_binary(directory: str, train: bool = True,
                        normalize: bool = True) -> List[Sample]:
    """CIFAR-10 from the binary-version batches (data_batch_*.bin /
    test_batch.bin): rows of [label u8 | 3072 u8 CHW pixels] -> NHWC."""
    pats = (["data_batch_*.bin"] if train else ["test_batch.bin"])
    files: List[str] = []
    for p in pats:
        files += sorted(glob.glob(os.path.join(directory, p)))
    if not files:
        raise FileNotFoundError(f"no CIFAR binary batches under {directory}")
    samples: List[Sample] = []
    for path in files:
        raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
        labels = raw[:, 0].astype(np.int32)
        imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        imgs = imgs.astype(np.float32)
        if normalize:
            imgs /= 255.0
        samples += [Sample(imgs[i], labels[i]) for i in range(len(labels))]
    return samples


def load_labeled_text_dir(directory: str,
                          categories: Optional[List[str]] = None
                          ) -> Tuple[List[Tuple[str, int]], List[str]]:
    """news20-style corpus: one subdirectory per category, one text file per
    document (news20.py get_news20 layout; also accepts a .tar.gz of that
    tree next to `directory`).  Returns ([(text, label_index)], categories)."""
    if not os.path.isdir(directory) and os.path.exists(directory):
        # a tarball: extract next to it (news20.py's extract step); the
        # top-level directory comes from the archive itself (e.g. news20's
        # tarball extracts to 20news-18828/, not the archive's basename)
        parent = os.path.dirname(os.path.abspath(directory))
        with tarfile.open(directory) as tf:
            tops = set()
            for m in tf.getmembers():
                name = m.name
                # GNU tar often stores './dir/...' members; normalize
                while name.startswith("./"):
                    name = name[2:]
                if not name or name in (".",) or \
                        name.startswith(("/", "..")):
                    continue
                tops.add(name.split("/", 1)[0])
            if len(tops) != 1:
                raise ValueError(
                    f"expected one top-level directory in {directory}, "
                    f"found {sorted(tops)}")
            dest = os.path.join(parent, next(iter(tops)))
            if not os.path.isdir(dest):  # don't re-extract on every call
                try:
                    tf.extractall(parent, filter="data")
                except TypeError:  # Python < 3.10.12: no filter kwarg —
                    # mirror filter="data": reject traversal/absolute/device
                    # members and links escaping the archive root
                    for m in tf.getmembers():
                        parts = m.name.replace("\\", "/").split("/")
                        if m.name.startswith("/") or ".." in parts or \
                                m.isdev():
                            raise ValueError(
                                f"unsafe tar member {m.name!r} in "
                                f"{directory}")
                        # mode parity with filter="data": strip
                        # setuid/setgid/sticky/world-write AND guarantee
                        # owner access (files rw, dirs rwx) so extracted
                        # trees stay readable
                        m.mode = (m.mode & 0o755) | \
                            (0o700 if m.isdir() else 0o600)
                        if m.islnk() or m.issym():
                            tgt = m.linkname.replace("\\", "/")
                            base = (os.path.dirname(m.name)
                                    if m.issym() else "")
                            resolved = os.path.normpath(
                                os.path.join(base, tgt))
                            if tgt.startswith("/") or \
                                    resolved.split("/")[0] == "..":
                                raise ValueError(
                                    f"tar link {m.name!r} -> {tgt!r} "
                                    f"escapes the archive in {directory}")
                    tf.extractall(parent)
        directory = dest
    cats = categories or sorted(
        d for d in os.listdir(directory)
        if os.path.isdir(os.path.join(directory, d)))
    if not cats:
        raise FileNotFoundError(f"no category directories under {directory}")
    out: List[Tuple[str, int]] = []
    for label, cat in enumerate(cats):
        for name in sorted(os.listdir(os.path.join(directory, cat))):
            path = os.path.join(directory, cat, name)
            if os.path.isfile(path):
                with open(path, "r", errors="replace") as f:
                    out.append((f.read(), label))
    return out, cats


def load_movielens(directory: str, filename: str = "ratings.dat"
                   ) -> np.ndarray:
    """MovieLens ratings (movielens.py read_data_sets role): parses the
    ml-1m `UserID::MovieID::Rating::Timestamp` format (also accepts
    comma-separated ml-latest CSV, skipping a header row if present) into
    a float32 (N, 3) array of [user_id, movie_id, rating] — float so
    ml-latest's half-star ratings survive (ids are exact in f32 up to
    2^24, far beyond any MovieLens id)."""
    path = os.path.join(directory, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found; place the MovieLens ratings file there "
            "(this loader does not download it)")
    rows: List[Tuple[float, float, float]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("::") if "::" in line else line.split(",")
            if len(parts) < 3:
                continue
            try:
                rows.append((float(int(parts[0])), float(int(parts[1])),
                             float(parts[2])))
            except ValueError:
                continue  # header row ("userId,movieId,...")
    if not rows:
        raise ValueError(f"no ratings parsed from {path}")
    return np.asarray(rows, dtype=np.float32)
