"""The port's BDRecord pipeline against the JAX package's, on the CPU.

- ``utils/recordio.py``: from the same dict records each package's
  ``write_records`` writes byte-identical shards (the port through its
  compiled codec, ``csrc/host/recordio.cc`` built here by ``g++``, and
  through its Python route); each package reads the other's; truncated
  and CRC-flipped shards give the same ``CorruptRecord`` offsets and
  ``resumable`` flags and the same skip-budget quarantine counts;
  ``count_records`` agrees; the compiled and Python routes read the same
  records.
- The unpickler: a shard of the reference's ``Sample`` s and
  ``LabeledImage`` s reads as the port's classes in a process where
  ``bigdl_tpu`` is never imported; another ``bigdl_tpu`` global raises.
- The readers: ``NativePrefetchReader`` and ``ThreadedShardReader`` give
  the multiset of a sequential read, each shard's records in file order.
- ``StreamingRecordDataSet``: the shard order of every epoch and, under
  an explicit ``process_index`` / ``process_count``, every rank's plan and
  cap equal the reference's; a pass through the prefetcher yields the
  records of the sequential one.
- ``utils/native.py``'s host kernels equal their Python routes.
Every comparison here is exact.
"""

import collections
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import StreamingRecordDataSet as JStream
from bigdl_tpu.dataset.image import LabeledImage as JLabeledImage
from bigdl_tpu.utils import recordio as jrec

from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import StreamingRecordDataSet as TStream
from bigdl_torch.dataset import ThreadedShardReader
from bigdl_torch.utils import native
from bigdl_torch.utils import recordio as trec

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = 4


def _records(n=23, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randint(0, 256, (5 + i % 3, 4, 3)).astype(np.uint8),
             "label": float(i % 5)} for i in range(n)]


@pytest.fixture
def python_route(monkeypatch):
    """Both packages' native libraries taken away: every entry point takes
    its Python route."""
    from bigdl_tpu.utils import native as jnative
    monkeypatch.setattr(native, "_state", {"lib": None, "tried": True})
    monkeypatch.setattr(jnative, "lib", None)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["label"] == y["label"]
        assert x["data"].dtype == y["data"].dtype
        assert np.array_equal(x["data"], y["data"])


def _bytes(paths):
    return [open(p, "rb").read() for p in paths]


def test_native_library_builds_here():
    assert native.is_native_loaded() and native.has_prefetch()


@pytest.mark.parametrize("shards", [1, SHARDS])
def test_write_records_byte_identical(tmp_path, shards, monkeypatch):
    recs = _records()
    jp = jrec.write_records(str(tmp_path / "j"), recs, shards=shards)
    tp = trec.write_records(str(tmp_path / "t"), recs, shards=shards)
    monkeypatch.setattr(native, "_state", {"lib": None, "tried": True})
    pp = trec.write_records(str(tmp_path / "p"), recs, shards=shards)
    assert [os.path.basename(p)[1:] for p in tp] == \
        [os.path.basename(p)[1:] for p in jp]
    assert _bytes(tp) == _bytes(jp) == _bytes(pp)


def test_each_reads_the_others_shards(tmp_path):
    recs = _records()
    jrec.write_records(str(tmp_path / "j"), recs, shards=SHARDS)
    trec.write_records(str(tmp_path / "t"), recs, shards=SHARDS)
    by_shard = [recs[i::SHARDS] for i in range(SHARDS)]
    want = [r for s in by_shard for r in s]
    _same(list(trec.read_records(str(tmp_path / "j"))), want)
    _same(list(jrec.read_records(str(tmp_path / "t"))), want)
    for p in trec.shard_paths(str(tmp_path / "j")):
        assert trec.count_records(p) == jrec.count_records(p)


def test_compiled_and_python_routes_read_the_same(tmp_path, monkeypatch):
    trec.write_records(str(tmp_path / "t"), _records(), shards=SHARDS)
    compiled = list(trec.read_records(str(tmp_path / "t")))
    monkeypatch.setattr(native, "_state", {"lib": None, "tried": True})
    _same(list(trec.read_records(str(tmp_path / "t"))), compiled)


def _damage(path, kind):
    data = bytearray(open(path, "rb").read())
    if kind == "truncate":
        data = data[:len(data) - 7]
    elif kind == "payload":
        data[len(data) // 2] ^= 0x40     # inside a payload
    else:  # a header's length field of the second record
        first = int.from_bytes(data[:8], "little")
        data[8 + 4 + first + 4] ^= 0x01
    open(path, "wb").write(bytes(data))


def _outcome(mod, path, budget, route=None):
    """(records read, error type, offset, resumable, quarantined)."""
    mod.reset_quarantine_stats()
    skip = mod.SkipBudget(budget)
    got, err = [], (None, None, None)
    try:
        for rec in mod.read_records(path, skip=skip):
            got.append(rec)
    except mod.CorruptRecord as e:
        err = (type(e).__name__, e.offset, e.resumable)
    return (len(got),) + err + (mod.quarantine_stats()["records"],
                                skip.count)


@pytest.mark.parametrize("kind", ["truncate", "payload", "header"])
@pytest.mark.parametrize("budget", [0, 1, 5])
def test_corrupt_shards_like_reference(tmp_path, kind, budget,
                                       python_route):
    path = str(tmp_path / "s")
    trec.write_records(path, _records(9))
    _damage(path, kind)
    assert _outcome(trec, path, budget) == _outcome(jrec, path, budget)


@pytest.mark.parametrize("kind", ["truncate", "payload", "header"])
def test_compiled_route_raises_typed(tmp_path, kind):
    """A fail-loud read takes the compiled reader, which cannot resync:
    the reference's native reader's contract (no offset, not
    resumable), and its outcome where its library is loaded."""
    from bigdl_tpu.utils import native as jnative
    path = str(tmp_path / "s")
    trec.write_records(path, _records(9))
    _damage(path, kind)
    got = _outcome(trec, path, 0)
    assert got[1:4] == ("CorruptRecord", None, False)
    if jnative.is_native_loaded():
        assert got == _outcome(jrec, path, 0)


def test_chaos_record_point_like_reference(tmp_path):
    from bigdl_tpu.utils import chaos as jchaos
    from bigdl_torch.utils import chaos as tchaos
    path = str(tmp_path / "s")
    trec.write_records(path, _records(9))
    out = []
    for mod, chaos in ((trec, tchaos), (jrec, jchaos)):
        with chaos.scoped("data.record=truncate@3"):
            out.append(_outcome(mod, path, 2))
    assert out[0] == out[1] and out[0][-1] == 1


def test_reference_samples_read_without_jax(tmp_path):
    rs = np.random.RandomState(1)
    recs = ([JSample(rs.standard_normal((3, 2)).astype(np.float32),
                     np.int32(i)) for i in range(3)] +
            [JSample([np.ones(2, np.float32), np.zeros(3, np.int64)],
                     [np.float32(1), np.int32(2)])] +
            [JLabeledImage(rs.standard_normal((4, 4, 3)).astype(np.float32),
                           2.0)])
    path = str(tmp_path / "ref")
    jrec.write_records(path, recs)
    code = f"""
import sys
import numpy as np
from bigdl_torch.utils.recordio import read_records
from bigdl_torch.dataset import Sample
from bigdl_torch.dataset.image import LabeledImage
got = list(read_records({path!r}))
assert [type(r) for r in got] == [Sample] * 4 + [LabeledImage], got
assert isinstance(got[3].feature, list) and got[4].label == 2.0
assert "bigdl_tpu" not in sys.modules and "jax" not in sys.modules
np.save({str(tmp_path / 'f.npy')!r}, got[0].feature)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=_REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert np.array_equal(np.load(tmp_path / "f.npy"), recs[0].feature)


def test_other_reference_global_raises(tmp_path):
    from bigdl_tpu.optim import SGD
    path = str(tmp_path / "bad")
    jrec.write_records(path, [{"x": 1}, SGD(0.1)])
    with pytest.raises(trec.ReferenceGlobalError):
        list(trec.read_records(path))
    with pytest.raises(trec.ReferenceGlobalError):
        trec.loads(pickle.dumps(SGD))


def _check_interleaved(got, by_shard):
    """``got`` holds each shard's records once, each shard's in order."""
    key = lambda r: (r["label"], r["data"].tobytes())  # noqa: E731
    assert collections.Counter(map(key, got)) == collections.Counter(
        key(r) for s in by_shard for r in s)
    for shard in by_shard:
        keys = [key(r) for r in shard]
        pos = [i for i, r in enumerate(got) if key(r) in set(keys)]
        assert [key(got[i]) for i in pos] == keys


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_readers_interleave_whole_shards(tmp_path, threads):
    recs = _records(61, seed=2)
    paths = trec.write_records(str(tmp_path / "t"), recs, shards=6)
    by_shard = [list(trec.read_records(p)) for p in paths]
    with native.NativePrefetchReader(paths, num_threads=threads,
                                     capacity=4) as r:
        _check_interleaved([trec.loads(b) for b in r], by_shard)
    with ThreadedShardReader(paths, threads, trec.read_records,
                             capacity=4) as r:
        _check_interleaved(list(r), by_shard)


def test_threaded_reader_raises_a_shard_error(tmp_path):
    paths = trec.write_records(str(tmp_path / "t"), _records(20), shards=4)
    _damage(paths[2], "payload")
    with pytest.raises(trec.CorruptRecord):
        with ThreadedShardReader(paths, 2, trec.read_records) as r:
            list(r)
    with pytest.raises(IOError):
        with native.NativePrefetchReader(paths, num_threads=2) as r:
            list(r)


def _plan_like_reference(tmp_path, count, epochs=3):
    recs = _records(41, seed=3)
    paths = trec.write_records(str(tmp_path / "t"), recs, shards=8)
    for rank in range(count):
        j = JStream(paths, seed=5, distributed=True, process_index=rank,
                    process_count=count)
        t = TStream(paths, seed=5, distributed=True, process_index=rank,
                    process_count=count)
        assert t.size() == j.size() == len(recs)
        for _ in range(epochs):
            j.shuffle()
            t.shuffle()
            assert list(t._order) == list(j._order)
            assert t._plan(t._order) == j._plan(j._order)
            _same(list(t.data(train=True)), list(j.data(train=True)))
        _same(list(t.data(train=False)), list(j.data(train=False)))


@pytest.mark.parametrize("count", [1, 2, 4])
def test_streaming_plan_like_reference(tmp_path, count):
    _plan_like_reference(tmp_path, count)


def test_streaming_threads_and_cached_sources(tmp_path):
    recs = _records(41, seed=4)
    paths = trec.write_records(str(tmp_path / "t"), recs, shards=8)
    seq = TStream(paths, seed=5)
    seq.shuffle()
    order = [paths[i] for i in seq._order]
    by_shard = [list(trec.read_records(p)) for p in order]
    for threads in (1, 4):
        t = TStream(paths, seed=5, num_threads=threads)
        t.shuffle()
        _check_interleaved(list(t.data(train=True)), by_shard)
    pattern = str(tmp_path / "t-*")
    j = JDataSet.record_files(pattern)
    for threads in (0, 3):
        got = TDataSet.record_files(pattern, num_threads=threads)
        if threads == 0:
            _same(got.records, j.records)
        else:
            _check_interleaved(got.records, [recs[i::8] for i in range(8)])
    with pytest.raises(ValueError):
        TStream(paths[:7], distributed=True, process_index=0,
                process_count=2)._plan(np.arange(7))
    # SequenceFile shards stream as the reference streams them
    from bigdl_tpu.dataset import seqfile as jseq
    seqdir = tmp_path / "seq"
    seqdir.mkdir()
    rs = np.random.RandomState(3)
    for k in range(3):
        jseq.write_seq_file(str(seqdir / f"p{k}.seq"), [
            (i % 5, rs.randint(0, 256, (4, 3, 3))) for i in range(6)])
    for class_num in (None, 3):
        ts = TDataSet.seq_file_folder(str(seqdir), class_num=class_num)
        js = JDataSet.seq_file_folder(str(seqdir), class_num=class_num)
        assert ts.size() == js.size()
        ts.shuffle()
        js.shuffle()
        for train in (False, True):
            a, b = list(ts.data(train)), list(js.data(train))
            assert len(a) == len(b) == ts.size()
            for u, w in zip(a, b):
                assert u.label == w.label and u.data.dtype == w.data.dtype
                assert np.array_equal(u.data, w.data)


def test_host_kernels_equal_python_routes(monkeypatch):
    rs = np.random.RandomState(0)
    a = rs.standard_normal(70001).astype(np.float32) * 1e3
    a[[1, 5, 9]] = [np.nan, -np.inf, -np.nan]
    rows = [rs.standard_normal((32, 33)).astype(np.float32)
            for _ in range(9)]
    bufs = [rs.standard_normal(70001).astype(np.float32) for _ in range(3)]
    compiled = (native.f32_to_bf16(a), native.bf16_to_f32(
        native.f32_to_bf16(a)), native.gather_rows(rows),
        native.reduce_sum_f32(bufs))
    monkeypatch.setattr(native, "_state", {"lib": None, "tried": True})
    plain = (native.f32_to_bf16(a), native.bf16_to_f32(
        native.f32_to_bf16(a)), native.gather_rows(rows),
        native.reduce_sum_f32(bufs))
    for c, p in zip(compiled, plain):
        assert c.dtype == p.dtype and np.array_equal(c, p, equal_nan=True)
    from bigdl_tpu.utils import native as jnative
    finite = np.isfinite(a)
    assert np.array_equal(plain[0][finite], jnative.f32_to_bf16(a[finite]))


def test_readers_under_thread_stress(tmp_path):
    """More reader threads than cores over many small shards, a ring of 2
    and a short switch interval: every record once, each shard in order,
    and every thread gone after close."""
    import threading
    recs = _records(96, seed=5)
    paths = trec.write_records(str(tmp_path / "t"), recs, shards=24)
    by_shard = [list(trec.read_records(p)) for p in paths]
    threads = 4 * (os.cpu_count() or 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            with native.NativePrefetchReader(paths, num_threads=threads,
                                             capacity=2) as r:
                _check_interleaved([trec.loads(b) for b in r], by_shard)
            reader = ThreadedShardReader(paths, threads, trec.read_records,
                                         capacity=2)
            with reader:
                _check_interleaved(list(reader), by_shard)
            assert not any(t.is_alive() for t in reader._threads)
    finally:
        sys.setswitchinterval(old)
    assert threading.active_count() < threads
