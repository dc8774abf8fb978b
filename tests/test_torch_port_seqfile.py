"""Hadoop SequenceFile shards against the JAX package.

- Hadoop's zero-compressed VInt: the port writes the reference's bytes for
  values across every length class (1 to 9 bytes, negative included) and
  reads them back.
- Each package reads the other's files (the writers draw their sync
  markers at random, so the files differ only there): keys, values,
  labels and pixels equal; names in keys (``name\\nlabel``) and sync
  markers every few records included; ``count_seq_records`` and the
  key-only walk agree.
- ``SeqFileDataSet`` / ``DataSet.seq_file_folder`` streams the reference's
  ``LabeledImage`` records in its shard order, with and without a
  ``class_num`` filter.
- Corruption: a short image value raises ``CorruptRecord`` in both, a skip
  budget quarantines it; a bad sync marker stays fatal; a compressed
  header raises naming its codec.
- ``record_generator --from-seq`` writes BDRecord shards byte-equal to the
  JAX ``record_generator``'s.
"""

import io
import os
import struct

import numpy as np
import pytest

from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import seqfile as jseq
from bigdl_tpu.tools import record_generator as jgen
from bigdl_tpu.utils.recordio import CorruptRecord as JCorrupt
from bigdl_tpu.utils.recordio import SkipBudget as JSkip

from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import seqfile as tseq
from bigdl_torch.tools import record_generator as tgen
from bigdl_torch.utils.recordio import CorruptRecord as TCorrupt
from bigdl_torch.utils.recordio import SkipBudget as TSkip

VINTS = [0, 1, -1, 127, -112, -113, 128, 255, 256, -129, 65535, 2 ** 24,
         -(2 ** 31), 2 ** 31 - 1, 2 ** 40, -(2 ** 55), 2 ** 63 - 1]


def _records(seed, n, named=False, hw=(4, 5)):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        img = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
        out.append((f"img_{seed}_{i}.JPEG", i % 6, img) if named
                   else (i % 6, img))
    return out


def test_vint_bytes_like_reference():
    for v in VINTS:
        a, b = io.BytesIO(), io.BytesIO()
        tseq._write_vint(a, v)
        jseq._write_vint(b, v)
        assert a.getvalue() == b.getvalue(), v
        assert tseq._read_vint(io.BytesIO(b.getvalue())) == v


@pytest.mark.parametrize("named", [False, True], ids=["label", "named"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_reads_the_others_files(tmp_path, named, writer):
    recs = _records(1, 11, named)
    path = str(tmp_path / "part-0.seq")
    (tseq if writer == "port" else jseq).write_seq_file(path, recs,
                                                        sync_interval=4)
    for reader in (tseq, jseq):
        pairs = list(reader.read_seq_file(path))
        assert len(pairs) == 11
        assert reader.count_seq_records(path) == 11
    assert list(tseq.read_seq_file(path)) == list(jseq.read_seq_file(path))
    assert list(tseq.iter_seq_keys(path)) == list(jseq.iter_seq_keys(path))
    got = list(tseq.read_byte_records(path))
    want = list(jseq.read_byte_records(path))
    for a, b, r in zip(got, want, recs):
        assert a["label"] == b["label"] == float(r[-2])
        assert a["data"].dtype == b["data"].dtype == np.uint8
        assert np.array_equal(a["data"], b["data"])
        assert np.array_equal(a["data"], r[-1])
    assert [r["label"] for r in tseq.read_byte_records(path, 3)] == \
        [r["label"] for r in jseq.read_byte_records(path, 3)]


@pytest.mark.parametrize("class_num", [None, 2])
def test_seq_file_folder_streams_like_reference(tmp_path, class_num):
    for k in range(3):
        jseq.write_seq_file(str(tmp_path / f"s{k}.seq"),
                            _records(k, 5 + k, hw=(3, 4)))
    (tmp_path / "other.bdr").write_bytes(b"not a seq file")
    assert tseq.find_seq_files(str(tmp_path)) == \
        jseq.find_seq_files(str(tmp_path))
    t = TDataSet.seq_file_folder(str(tmp_path), class_num=class_num)
    j = JDataSet.seq_file_folder(str(tmp_path), class_num=class_num)
    assert isinstance(t, tseq.SeqFileDataSet)
    assert t.size() == j.size()
    for _ in range(2):
        t.shuffle()
        j.shuffle()
        a, b = list(t.data(train=True)), list(j.data(train=True))
        assert [x.label for x in a] == [x.label for x in b]
        for x, y in zip(a, b):
            assert x.data.dtype == y.data.dtype == np.float32
            assert np.array_equal(x.data, y.data)
    with pytest.raises(FileNotFoundError):
        tseq.seq_file_folder(str(tmp_path / "empty"))


def _corrupt_value(path):
    """The second record's value cut short: its stored width is raised."""
    data = bytearray(open(path, "rb").read())
    pairs = list(jseq.read_seq_file(path))
    value = pairs[1][1]
    at = bytes(data).index(value)
    data[at:at + 4] = struct.pack(">i", 1000)
    open(path, "wb").write(bytes(data))


def test_corrupt_records_like_reference(tmp_path):
    path = str(tmp_path / "c.seq")
    jseq.write_seq_file(path, _records(2, 6))
    _corrupt_value(path)
    with pytest.raises(TCorrupt, match="corrupt image record"):
        list(tseq.read_byte_records(path))
    with pytest.raises(JCorrupt, match="corrupt image record"):
        list(jseq.read_byte_records(path))
    ts, js = TSkip(1), JSkip(1)
    got = list(tseq.read_byte_records(path, skip=ts))
    want = list(jseq.read_byte_records(path, skip=js))
    assert len(got) == len(want) == 5 and ts.count == js.count == 1
    # a bad sync marker is fatal whatever the budget
    bad = str(tmp_path / "s.seq")
    jseq.write_seq_file(bad, _records(3, 8), sync_interval=3)
    data = bytearray(open(bad, "rb").read())
    at = bytes(data).index(struct.pack(">i", -1)) + 4
    data[at] ^= 0xFF
    open(bad, "wb").write(bytes(data))
    with pytest.raises(TCorrupt, match="sync marker"):
        list(tseq.read_byte_records(bad, skip=TSkip(5)))


def test_compressed_header_raises(tmp_path):
    path = tmp_path / "z.seq"
    f = io.BytesIO()
    f.write(b"SEQ\x06")
    for cls in (b"org.apache.hadoop.io.Text",) * 2:
        tseq._write_text(f, cls)
    f.write(b"\x01\x00")
    tseq._write_text(f, b"org.apache.hadoop.io.compress.DefaultCodec")
    path.write_bytes(f.getvalue())
    for mod in (tseq, jseq):
        with pytest.raises(ValueError, match="DefaultCodec"):
            list(mod.read_seq_file(str(path)))


def test_from_seq_shards_byte_equal_reference(tmp_path):
    src = tmp_path / "seq"
    os.makedirs(src)
    for k in range(2):
        tseq.write_seq_file(str(src / f"part-{k:05d}.seq"),
                            _records(k + 5, 9, named=k == 1, hw=(6, 5)))
    os.makedirs(tmp_path / "j")
    tp, tn = tgen.main(["--from-seq", "--folder", str(src), "--output",
                        str(tmp_path / "t" / "train"), "--shards", "4"])
    jgen.main(["--from-seq", "--folder", str(src), "--output",
               str(tmp_path / "j" / "train"), "--shards", "4"])
    jp = sorted(str(p) for p in (tmp_path / "j").iterdir())
    assert tn == 18 and len(tp) == len(jp) == 4
    assert [open(p, "rb").read() for p in sorted(tp)] == \
        [open(p, "rb").read() for p in jp]
    with pytest.raises(SystemExit):
        tgen.main(["--folder", str(src), "--output", "x",
                   "--class-num", "3"])
