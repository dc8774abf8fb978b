"""DataSet: data sources feeding the Optimizer.

Counterpart of ``bigdl_tpu/dataset/__init__.py`` (reference
``dataset/DataSet.scala``): ``DataSet.array`` over a record list (with
group-wise shuffling, ``DataSet.sorted_array``), transformed into
MiniBatches by ``SampleToMiniBatch``; its per-process sharded form
``DistributedDataSet`` (``DataSet.array(..., distributed=True)``,
``DataSet.rdd``) for data-parallel training; the BDRecord sources
(``DataSet.record_file``, ``record_files`` cached in memory,
``record_stream`` re-read from disk every pass as a
:class:`StreamingRecordDataSet`) and ``DataSet.image_folder``; and
``PrefetchIterator``, the worker thread the Optimizer reads its batches
through.  Every shuffle is drawn from ``np.random.default_rng(seed)``
exactly as the reference draws it, so both packages visit records (or
shards) in the same order from the same seed.  The rank of a sharded
source is the Engine's (``torch.distributed``), where the reference asks
``jax.process_index()``.  The text pipeline (``text.py``), the tabular
recommendation data (``recsys.py``), Hadoop SequenceFile shards
(``DataSet.seq_file_folder``, ``seqfile.py``) and the standard datasets'
file parsers (``providers.py``) sit beside them.
"""

from __future__ import annotations

import glob
import logging
from typing import Iterator, Optional, Sequence

import numpy as np

from ..utils.engine import Engine
from .prefetch import PrefetchIterator, ThreadedShardReader
from .sample import FixedLength, MiniBatch, PaddingParam, Sample
from .transformer import (ChainedTransformer, Identity, MTSampleToMiniBatch,
                          SampleToMiniBatch, Transformer)
from .text import (Dictionary, LabeledSentence, LabeledSentenceToSample,
                   SentenceBiPadding, SentenceSplitter, SentenceTokenizer,
                   TextToLabeledSentence)
from .recsys import (FeatureSpec, TabularToSample, cross_bucket,
                     hash_bucket, synthetic_criteo_records,
                     write_criteo_shards)

logger = logging.getLogger("bigdl_torch")

__all__ = ["AbstractDataSet", "LocalArrayDataSet", "DistributedDataSet",
           "StreamingRecordDataSet", "TransformedDataSet", "DataSet",
           "Sample", "MiniBatch", "PaddingParam", "FixedLength",
           "Transformer", "ChainedTransformer", "SampleToMiniBatch",
           "MTSampleToMiniBatch", "Identity", "PrefetchIterator",
           "ThreadedShardReader", "SentenceSplitter", "SentenceTokenizer",
           "SentenceBiPadding", "Dictionary", "LabeledSentence",
           "TextToLabeledSentence", "LabeledSentenceToSample",
           "FeatureSpec", "TabularToSample", "hash_bucket", "cross_bucket",
           "synthetic_criteo_records", "write_criteo_shards"]


class AbstractDataSet:
    """(reference: dataset/DataSet.scala:46)."""

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def data(self, train: bool) -> Iterator:
        """One pass over the (transformed) records; the Optimizer calls it
        once per epoch."""
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    __rshift__ = transform


class LocalArrayDataSet(AbstractDataSet):
    """In-memory record list (reference: dataset/DataSet.scala:128).

    ``group_size > 1`` shuffles groups of consecutive records, each group
    kept in order (the reference's ``groupSize``, DataSet.scala:240):
    records sorted by length keep their batches length-homogeneous."""

    def __init__(self, records: Sequence, seed: int = 1,
                 group_size: int = 1):
        self.records = list(records)
        self.group_size = max(1, int(group_size))
        self._perm = np.arange(len(self.records))
        self._rng = np.random.default_rng(seed)

    def size(self) -> int:
        return len(self.records)

    def shuffle(self) -> None:
        if self.group_size == 1:
            self._rng.shuffle(self._perm)
            return
        n = len(self.records)
        if n == 0:
            return
        starts = np.arange(0, n, self.group_size)
        self._rng.shuffle(starts)
        self._perm = np.concatenate(
            [np.arange(s, min(s + self.group_size, n)) for s in starts])

    def data(self, train: bool) -> Iterator:
        order = self._perm if train else np.arange(len(self.records))
        for i in order:
            yield self.records[i]


class DistributedDataSet(AbstractDataSet):
    """Per-process sharded records (reference: CachedDistriDataSet,
    dataset/DataSet.scala:240).

    Every process holds the FULL record list and draws the same seeded
    permutation; each data pass yields only this process's stride of it,
    ``order[index::count]``, truncated to ``len // count`` so that every
    process yields the same number of records (a rank that left the epoch
    early would deadlock the per-step collectives).  The shard is
    (``process_index``, ``process_count``) where given, each in place of
    its half of the Engine's ``data_shard_info()``, which is read at each
    pass.  ``size()`` is the global count."""

    def __init__(self, records: Sequence, seed: int = 1,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self._explicit_shard = (process_index, process_count)
        self._all = list(records)
        self._rng = np.random.default_rng(seed)
        self._perm = np.arange(len(self._all))

    def _shard(self):
        pi, pc = self._explicit_shard
        si, sc = Engine.data_shard_info()
        return (si if pi is None else pi, sc if pc is None else pc)

    @property
    def process_index(self) -> int:
        return self._shard()[0]

    @property
    def process_count(self) -> int:
        return self._shard()[1]

    def size(self) -> int:
        return len(self._all)

    def local_size(self) -> int:
        return len(self._all) // self._shard()[1]

    def shuffle(self) -> None:
        self._rng.shuffle(self._perm)

    def data(self, train: bool) -> Iterator:
        order = self._perm if train else np.arange(len(self._all))
        index, count = self._shard()
        for i in order[index::count][:len(order) // count]:
            yield self._all[i]


class StreamingRecordDataSet(AbstractDataSet):
    """BDRecord shards re-read from disk every pass (the reference's,
    ``dataset/__init__.py:178-340``): the out-of-core source.

    ``shuffle()`` permutes the shard order from ``default_rng(seed)``;
    records keep their order inside a shard.  Under ``distributed=True``
    each process streams the shards ``order[rank::count]`` (the shard
    count must divide by the process count) and every process stops at
    the smallest rank's record count for this order, so all take the same
    number of steps.  The rank is ``process_index`` / ``process_count``
    where given, else the Engine's.  A training pass with ``num_threads``
    > 0 reads through the native prefetcher, or the Python
    :class:`ThreadedShardReader` where the library is absent; an eval
    pass, a positive ``skip_budget`` (default
    ``BIGDL_TORCH_DATA_SKIP_BUDGET``) or an armed ``data.record`` chaos
    point reads shard by shard in order.  ``last_quarantined`` counts the
    corrupt records the last pass skipped."""

    def __init__(self, paths, seed: int = 1, num_threads: int = 0,
                 distributed: bool = False,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 skip_budget: Optional[int] = None):
        self.paths = [str(p) for p in paths]
        if not self.paths:
            raise FileNotFoundError("no record shards")
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(len(self.paths))
        self.num_threads = num_threads
        self.distributed = distributed
        self._explicit_shard = (process_index, process_count)
        self._counts = None
        self.skip_budget = skip_budget
        self.last_quarantined = 0

    def _shard(self):
        pi, pc = self._explicit_shard
        si, sc = Engine.data_shard_info()
        return (si if pi is None else pi, sc if pc is None else pc)

    def _shard_counts(self):
        if self._counts is None:
            from ..utils.recordio import count_records
            self._counts = [count_records(p) for p in self.paths]
        return self._counts

    def size(self) -> int:
        return sum(self._shard_counts())

    def shuffle(self) -> None:
        self._rng.shuffle(self._order)

    def _plan(self, order):
        """(this process's shard paths, record cap or None) for an
        order."""
        if not self.distributed:
            return [self.paths[i] for i in order], None
        rank, count = self._shard()
        if count > 1 and len(self.paths) % count:
            raise ValueError(
                f"streaming dataset: {len(self.paths)} shards not "
                f"divisible by {count} processes; tail shards would be "
                "left out of every pass: re-shard the corpus")
        if count <= 1:
            return [self.paths[i] for i in order], None
        counts = self._shard_counts()
        cap = min(sum(counts[i] for i in order[r::count])
                  for r in range(count))
        return [self.paths[i] for i in order[rank::count]], cap

    def _read_shard(self, path: str, skip=None) -> Iterator:
        from ..utils.recordio import read_records
        return read_records(path, skip=skip)

    def data(self, train: bool) -> Iterator:
        from ..utils import chaos, native
        from ..utils.recordio import SkipBudget, loads
        order = self._order if train else np.arange(len(self.paths))
        paths, cap = self._plan(order)
        emitted = 0
        skip = SkipBudget(self.skip_budget)
        try:
            if train and self.num_threads > 0 and skip.budget <= 0 and \
                    not chaos.armed("data.record"):
                if native.has_prefetch():
                    reader = native.NativePrefetchReader(
                        paths, num_threads=self.num_threads)
                    decode = loads
                else:
                    reader = ThreadedShardReader(
                        paths, self.num_threads,
                        lambda p: self._read_shard(p, skip=skip))
                    decode = None
                with reader:
                    for rec in reader:
                        if cap is not None and emitted >= cap:
                            return
                        emitted += 1
                        yield rec if decode is None else decode(rec)
                return
            for p in paths:
                for rec in self._read_shard(p, skip=skip):
                    if cap is not None and emitted >= cap:
                        return
                    emitted += 1
                    yield rec
        finally:
            self.last_quarantined = skip.count
            if skip.count:
                logger.warning(
                    "data pass complete: quarantined %d corrupt record(s) "
                    "(budget %d)", skip.count, skip.budget)


def _shard_list(pattern):
    paths = (sorted(glob.glob(pattern)) if isinstance(pattern, str)
             else list(pattern))
    if not paths:
        raise FileNotFoundError(f"no record shards match {pattern!r}")
    return paths


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def shuffle(self) -> None:
        self.base.shuffle()

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(
            self.base, ChainedTransformer(self.transformer, transformer))

    __rshift__ = transform


class DataSet:
    """Builder namespace (reference: object DataSet,
    dataset/DataSet.scala:319)."""

    @staticmethod
    def array(records, distributed: bool = False, seed: int = 1):
        if distributed:
            return DistributedDataSet(records, seed=seed)
        return LocalArrayDataSet(records, seed=seed)

    @staticmethod
    def sorted_array(records, key, group_size: int, seed: int = 1):
        """Records sorted by ``key`` (a sequence length, say), shuffled in
        groups of ``group_size`` (DataSet.scala:372, :240)."""
        return LocalArrayDataSet(sorted(records, key=key), seed=seed,
                                 group_size=group_size)

    @staticmethod
    def rdd(records, seed: int = 1):
        """The reference's Spark-RDD source: records sharded over the
        processes of the data group."""
        return DistributedDataSet(records, seed=seed)

    @staticmethod
    def image_folder(path, distributed: bool = False):
        """A folder per class of images -> LabeledImage records
        (DataSet.ImageFolder; labels by sorted class-folder name)."""
        from .image import load_image_folder
        return DataSet.array(load_image_folder(path), distributed=distributed)

    @staticmethod
    def record_file(path, distributed: bool = False):
        """One BDRecord shard (or glob, or sharded base) in memory."""
        from ..utils.recordio import read_records
        return DataSet.array(list(read_records(path)),
                             distributed=distributed)

    @staticmethod
    def seq_file_folder(folder, class_num=None, distributed: bool = False,
                        **kw):
        """Hadoop SequenceFile shards (``*.seq`` under ``folder``, the
        reference's ImageNet format) streamed every pass as
        ``LabeledImage`` records, labels above ``class_num`` left out
        (DataSet.SeqFileFolder; ``seqfile.SeqFileDataSet``)."""
        from .seqfile import seq_file_folder
        return seq_file_folder(folder, class_num=class_num,
                               distributed=distributed, **kw)

    @staticmethod
    def record_files(pattern, distributed: bool = False, seed: int = 1,
                     num_threads: int = 0):
        """A glob (or list) of BDRecord shards cached in memory as one
        dataset.  ``num_threads`` > 0 loads them through the native
        prefetcher (or the Python :class:`ThreadedShardReader`), records
        interleaved across shards; under ``distributed=True`` every
        process must hold the same list, so the load is sequential."""
        from ..utils import native
        from ..utils.recordio import loads, read_records
        paths = _shard_list(pattern)
        if num_threads > 0 and not distributed:
            if native.has_prefetch():
                with native.NativePrefetchReader(
                        paths, num_threads=num_threads) as reader:
                    records = [loads(b) for b in reader]
            else:
                with ThreadedShardReader(paths, num_threads,
                                         read_records) as reader:
                    records = list(reader)
        else:
            records = [rec for p in paths for rec in read_records(p)]
        return DataSet.array(records, distributed=distributed, seed=seed)

    @staticmethod
    def record_stream(pattern, distributed: bool = False, seed: int = 1,
                      num_threads: int = 0, process_index=None,
                      process_count=None, skip_budget=None):
        """The shards of ``pattern`` re-read every pass
        (:class:`StreamingRecordDataSet`)."""
        return StreamingRecordDataSet(
            _shard_list(pattern), seed=seed, num_threads=num_threads,
            distributed=distributed, process_index=process_index,
            process_count=process_count, skip_budget=skip_budget)
