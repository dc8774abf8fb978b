"""Tabular recommendation data (Criteo-style) for Wide & Deep.

Counterpart of ``bigdl_tpu/dataset/recsys.py``: the same hashing, the same
feature layout and the same seeded synthetic records, so both packages
featurize a record into the same float32 vector and write the same shard
bytes.

Layout produced by :class:`TabularToSample`, one flat float32 vector per
record, read by ``models/widedeep.WideDeep``:

    [0 : n_deep_slots)                  deep ids: one global id per one-hot
                                        column, then ``multihot_slots`` tag
                                        ids (-1 = empty slot)
    [n_deep_slots : +n_wide)            wide cross-product ids
    [n_deep_slots + n_wide : input_dim) dense floats, log1p-compressed

Ids are global rows of one shared deep table: column ``c`` owns rows
``[c * stride, (c + 1) * stride)`` with ``stride = deep_buckets //
n_columns``.  Hashing is ``zlib.crc32`` with a salt per column, the same in
every process (Python's ``hash()`` is salted per process).
"""

from __future__ import annotations

import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.recordio import CorruptRecord, write_records
from .sample import Sample
from .transformer import Transformer

__all__ = ["hash_bucket", "cross_bucket", "FeatureSpec", "TabularToSample",
           "synthetic_criteo_records", "write_criteo_shards"]


def hash_bucket(value, buckets: int, salt: str = "") -> int:
    """Stable (process-independent) hash of ``value`` into [0, buckets)."""
    data = f"{salt}\x1f{value}".encode("utf-8")
    return zlib.crc32(data) % buckets


def cross_bucket(values: Sequence, buckets: int, salt: str = "cross") -> int:
    """Stable hash of a cross-product feature (a tuple of column values)."""
    data = (salt + "\x1f" + "\x1f".join(str(v) for v in values)).encode(
        "utf-8")
    return zlib.crc32(data) % buckets


class FeatureSpec:
    """Schema and featurization rules of one tabular workload: ``n_cat``
    one-hot categorical columns, one multi-valued tag column in
    ``multihot_slots`` fixed slots (-1 pads empty ones), ``n_dense`` float
    columns, and ``cross_pairs`` wide cross-product features (default:
    every adjacent pair of one-hot columns).  The deep table's
    ``deep_buckets`` rows are split evenly over the ``n_cat + 1`` columns;
    the crosses hash into a separate ``wide_buckets``-row table."""

    def __init__(self, n_cat: int = 8, n_dense: int = 4,
                 multihot_slots: int = 4, deep_buckets: int = 8192,
                 wide_buckets: int = 4096,
                 cross_pairs: Optional[Sequence[Tuple[int, int]]] = None):
        if n_cat < 1 or n_dense < 0 or multihot_slots < 0:
            raise ValueError("FeatureSpec: need n_cat >= 1, n_dense >= 0, "
                             "multihot_slots >= 0")
        self.n_cat = n_cat
        self.n_dense = n_dense
        self.multihot_slots = multihot_slots
        self.deep_buckets = deep_buckets
        self.wide_buckets = wide_buckets
        if cross_pairs is None:
            cross_pairs = [(i, i + 1) for i in range(n_cat - 1)]
        for a, b in cross_pairs:
            if not (0 <= a < n_cat and 0 <= b < n_cat):
                raise ValueError(f"cross pair ({a},{b}) out of range for "
                                 f"{n_cat} categorical columns")
        self.cross_pairs = [tuple(p) for p in cross_pairs]
        self.n_columns = n_cat + (1 if multihot_slots else 0)
        self.stride = deep_buckets // self.n_columns
        if self.stride < 1:
            raise ValueError(f"deep_buckets={deep_buckets} < "
                             f"{self.n_columns} columns")

    @property
    def n_deep_slots(self) -> int:
        return self.n_cat + self.multihot_slots

    @property
    def n_wide(self) -> int:
        return len(self.cross_pairs)

    @property
    def input_dim(self) -> int:
        return self.n_deep_slots + self.n_wide + self.n_dense

    def deep_id(self, col: int, value) -> int:
        return col * self.stride + hash_bucket(value, self.stride,
                                               salt=f"col{col}")

    def tag_id(self, value) -> int:
        return self.deep_id(self.n_cat, value)

    def wide_id(self, pair_index: int, cats: Sequence) -> int:
        a, b = self.cross_pairs[pair_index]
        return cross_bucket((cats[a], cats[b]), self.wide_buckets,
                            salt=f"x{a}-{b}")

    def featurize(self, record) -> Sample:
        """One raw record dict -> Sample.  A record that breaks the schema
        raises :class:`CorruptRecord`, as a payload that fails its CRC
        does."""
        try:
            cats = record["cats"]
            dense = record["dense"]
            tags = record.get("tags", [])
            label = record["label"]
        except (TypeError, KeyError, IndexError, AttributeError) as e:
            raise CorruptRecord(
                f"recsys record malformed ({type(e).__name__}: {e})")
        if len(cats) != self.n_cat or len(dense) != self.n_dense:
            raise CorruptRecord(
                f"recsys record arity mismatch: {len(cats)} cat / "
                f"{len(dense)} dense columns, spec wants "
                f"{self.n_cat}/{self.n_dense}")
        try:
            deep = [float(self.deep_id(c, v)) for c, v in enumerate(cats)]
            # the first K tags in sorted order, -1 pads the rest
            kept = sorted(str(t) for t in tags)[:self.multihot_slots]
            slots = [float(self.tag_id(t)) for t in kept]
            slots += [-1.0] * (self.multihot_slots - len(slots))
            wide = [float(self.wide_id(i, cats))
                    for i in range(len(self.cross_pairs))]
            dvals = np.log1p(np.maximum(
                np.asarray(dense, dtype=np.float64), 0.0))
            feat = np.concatenate(
                [np.asarray(deep + slots + wide, dtype=np.float64),
                 dvals]).astype(np.float32)
            lab = np.array(int(label), dtype=np.int32)
        except (TypeError, ValueError) as e:
            raise CorruptRecord(
                f"recsys record unfeaturizable ({type(e).__name__}: {e})")
        return Sample(feat, lab)


class TabularToSample(Transformer):
    """Raw tabular record dicts -> Samples, by a :class:`FeatureSpec`;
    raises :class:`CorruptRecord` on a record that breaks the schema."""

    def __init__(self, spec: FeatureSpec):
        self.spec = spec

    def __call__(self, it: Iterator) -> Iterator[Sample]:
        for record in it:
            yield self.spec.featurize(record)


def synthetic_criteo_records(n: int, spec: Optional[FeatureSpec] = None,
                             seed: int = 1, col_vocab: int = 100,
                             max_tags: int = 3) -> Iterator[dict]:
    """Seeded Criteo-style raw records.  The label can be learned: each
    categorical value carries a fixed crc-derived weight in [-1, 1], and
    the label is 1 where the weights' sum plus a dense term is positive.
    The same seed gives the same records in every process."""
    spec = spec or FeatureSpec()
    rng = np.random.default_rng(seed)
    for _ in range(n):
        cats = [f"c{c}:v{int(rng.integers(col_vocab))}"
                for c in range(spec.n_cat)]
        k = int(rng.integers(0, max_tags + 1)) if spec.multihot_slots else 0
        tags = [f"t:v{int(rng.integers(col_vocab))}" for _ in range(k)]
        dense = rng.gamma(2.0, 2.0, spec.n_dense)
        score = sum((zlib.crc32(("w\x1f" + v).encode()) % 1001) / 500.0 - 1.0
                    for v in cats)
        if spec.n_dense:
            score += float(np.log1p(dense).mean()) - np.log1p(4.0)
        yield {"cats": cats, "tags": tags,
               "dense": [float(d) for d in dense],
               "label": int(score > 0)}


def write_criteo_shards(path: str, n: int, shards: int = 4, seed: int = 1,
                        spec: Optional[FeatureSpec] = None,
                        **gen_kw) -> List[str]:
    """``n`` synthetic raw records as BDRecord shards (read them back with
    ``DataSet.record_stream(...) >> TabularToSample(spec)``)."""
    return write_records(path, synthetic_criteo_records(n, spec=spec,
                                                        seed=seed, **gen_kw),
                         shards=shards)
