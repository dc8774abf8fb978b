"""The text pipeline and the dataset providers against the JAX package.

- ``SentenceSplitter`` -> ``SentenceTokenizer`` -> ``SentenceBiPadding``
  -> ``Dictionary`` -> ``TextToLabeledSentence`` ->
  ``LabeledSentenceToSample`` (index and one-hot forms, fixed lengths
  padded and cut) give the reference's tokens, indices and arrays exactly.
- A ``Dictionary`` saved by either package loads in the other with the
  same words and indices, UNK last; a file that breaks that contract
  raises in both.
- ``load_mnist`` (idx files gzipped and not), ``load_cifar10_binary``,
  ``load_labeled_text_dir`` (a folder and its tarball) and
  ``load_movielens`` (``::`` and CSV with a header) on files written to
  ``tmp_path``: the same arrays, labels and order.
- ``fetch_file`` on ``memory://`` sources: the bytes, the cached copy
  reused, and a size or checksum mismatch raising
  ``DownloadIntegrityError`` with nothing left at the destination.
"""

import gzip
import hashlib
import os
import struct
import tarfile

import numpy as np
import pytest

from bigdl_tpu.dataset import providers as jprov
from bigdl_tpu.dataset import text as jtext

from bigdl_torch.dataset import providers as tprov
from bigdl_torch.dataset import text as ttext
from bigdl_torch.utils import file_io

DOCS = ["The cat sat. The dog ran! Did it? Yes it did.",
        "A bird's song... isn't it loud? It is, really loud.",
        "one"]


def _tokens(mod):
    sents = [s for doc in mod.SentenceSplitter()(iter(DOCS)) for s in doc]
    toks = list(mod.SentenceTokenizer()(iter(sents)))
    return sents, toks, list(mod.SentenceBiPadding()(iter(toks)))


def test_split_tokenize_pad_like_reference():
    assert _tokens(ttext) == _tokens(jtext)


@pytest.mark.parametrize("vocab", [None, 6])
@pytest.mark.parametrize("form", [
    dict(), dict(vocab_length=True),
    dict(fixed_data_length=5, fixed_label_length=7),
    dict(vocab_length=True, fixed_data_length=9, fixed_label_length=3)],
    ids=["index", "onehot", "fixed", "onehot_fixed"])
def test_labeled_sentences_like_reference(vocab, form):
    out = {}
    for name, mod in (("t", ttext), ("j", jtext)):
        padded = _tokens(mod)[2]
        d = mod.Dictionary(padded, vocab_size=vocab)
        kw = dict(form)
        if kw.get("vocab_length"):
            kw["vocab_length"] = d.vocab_size()
        ls = list(mod.TextToLabeledSentence(d)(iter(padded)))
        samples = list(mod.LabeledSentenceToSample(**kw)(iter(ls)))
        out[name] = (d.index2word(), d.unk_index(),
                     [(a.data.tolist(), a.label.tolist()) for a in ls],
                     [(s.feature, s.label) for s in samples])
    t, j = out["t"], out["j"]
    assert t[:3] == j[:3]
    assert len(t[3]) == len(j[3])
    for (tf, tl), (jf, jl) in zip(t[3], j[3]):
        assert tf.dtype == jf.dtype and np.array_equal(tf, jf)
        assert tl.dtype == jl.dtype and np.array_equal(tl, jl)


def test_dictionary_round_trip(tmp_path):
    padded = _tokens(ttext)[2]
    td = ttext.Dictionary(padded, vocab_size=8)
    jd = jtext.Dictionary(padded, vocab_size=8)
    td.save(str(tmp_path / "t"))
    jd.save(str(tmp_path / "j"))
    assert open(tmp_path / "t" / "dictionary.json", "rb").read() == \
        open(tmp_path / "j" / "dictionary.json", "rb").read()
    a = jtext.Dictionary.load(str(tmp_path / "t"))
    b = ttext.Dictionary.load(str(tmp_path / "j"))
    for d in (a, b):
        assert d.index2word() == td.index2word()
        assert d.unk_index() == d.vocab_size() - 1
        assert d.get_index("never-seen") == d.unk_index()
        assert d.encode(["the", "cat"]).tolist() == \
            td.encode(["the", "cat"]).tolist()
    os.makedirs(tmp_path / "bad")
    (tmp_path / "bad" / "dictionary.json").write_text('["a", "b"]')
    for mod in (ttext, jtext):
        with pytest.raises(ValueError, match="UNK"):
            mod.Dictionary.load(str(tmp_path / "bad"))


def _write_idx(path, arr, code):
    head = struct.pack(">I", (code << 8) | arr.ndim)
    head += b"".join(struct.pack(">I", n) for n in arr.shape)
    data = head + arr.tobytes()
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def _same_samples(a, b):
    assert len(a) == len(b)
    for s, t in zip(a, b):
        assert s.feature.dtype == t.feature.dtype
        assert np.array_equal(s.feature, t.feature)
        assert s.label.dtype == t.label.dtype and s.label == t.label


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
@pytest.mark.parametrize("data_type", ["train", "test"])
def test_load_mnist_like_reference(tmp_path, gz, data_type):
    rs = np.random.RandomState(1)
    prefix = "train" if data_type == "train" else "t10k"
    ext = ".gz" if gz else ""
    _write_idx(str(tmp_path / f"{prefix}-images-idx3-ubyte{ext}"),
               rs.randint(0, 256, (7, 28, 28)).astype(np.uint8), 0x08)
    _write_idx(str(tmp_path / f"{prefix}-labels-idx1-ubyte{ext}"),
               rs.randint(0, 10, 7).astype(np.uint8), 0x08)
    for normalize in (True, False):
        got = tprov.load_mnist(str(tmp_path), data_type, normalize)
        want = jprov.load_mnist(str(tmp_path), data_type, normalize)
        _same_samples(got, want)
        assert got[0].feature.shape == (28, 28, 1)


def test_load_cifar10_binary_like_reference(tmp_path):
    rs = np.random.RandomState(2)
    for name, n in (("data_batch_1.bin", 3), ("data_batch_2.bin", 2),
                    ("test_batch.bin", 4)):
        rows = np.concatenate(
            [rs.randint(0, 10, (n, 1)), rs.randint(0, 256, (n, 3072))],
            axis=1).astype(np.uint8)
        rows.tofile(str(tmp_path / name))
    for train in (True, False):
        got = tprov.load_cifar10_binary(str(tmp_path), train)
        _same_samples(got, jprov.load_cifar10_binary(str(tmp_path), train))
        assert got[0].feature.shape == (32, 32, 3)
    with pytest.raises(FileNotFoundError):
        tprov.load_cifar10_binary(str(tmp_path / "none"))


def test_load_labeled_text_dir_like_reference(tmp_path):
    root = tmp_path / "news" / "20news"
    for cat, docs in (("sci", ["atoms", "stars"]), ("alt", ["why"]),
                      ("rec", ["ball", "bat", "run"])):
        os.makedirs(root / cat)
        for i, d in enumerate(docs):
            (root / cat / f"{i}.txt").write_text(d)
    got = tprov.load_labeled_text_dir(str(root))
    assert got == jprov.load_labeled_text_dir(str(root))
    assert got[1] == ["alt", "rec", "sci"]
    assert tprov.load_labeled_text_dir(str(root), ["sci", "alt"]) == \
        jprov.load_labeled_text_dir(str(root), ["sci", "alt"])
    # the tarball form extracts its one top-level folder beside itself
    for name in ("t", "j"):
        os.makedirs(tmp_path / name)
        tar = tmp_path / name / "news.tar.gz"
        with tarfile.open(tar, "w:gz") as tf:
            tf.add(root, arcname="20news")
    got = tprov.load_labeled_text_dir(str(tmp_path / "t" / "news.tar.gz"))
    want = jprov.load_labeled_text_dir(str(tmp_path / "j" / "news.tar.gz"))
    assert got == want == tprov.load_labeled_text_dir(str(root))


@pytest.mark.parametrize("form", ["dat", "csv"])
def test_load_movielens_like_reference(tmp_path, form):
    if form == "dat":
        text = "1::10::5::97\n2::11::3::98\n\nbad\n3::12::4::99\n"
        name = "ratings.dat"
    else:
        text = "userId,movieId,rating,timestamp\n1,10,4.5,9\n2,20,3.0,9\n"
        name = "ratings.csv"
    (tmp_path / name).write_text(text)
    got = tprov.load_movielens(str(tmp_path), name)
    want = jprov.load_movielens(str(tmp_path), name)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        tprov.load_movielens(str(tmp_path), "missing.dat")


def _memory(path, payload):
    import fsspec
    fsspec.filesystem("memory").pipe_file(path, payload)


def test_fetch_file_memory_source(tmp_path):
    payload = b"idx-bytes" * 300
    _memory("/torch_prov/a.bin", payload)
    dest = str(tmp_path / "sub" / "a.bin")
    sha = hashlib.sha256(payload).hexdigest()
    got = tprov.fetch_file("memory://torch_prov/a.bin", dest,
                           expected_size=len(payload), expected_sha256=sha)
    assert got == dest and open(dest, "rb").read() == payload
    # a verified cached copy is reused: the source may be gone
    _memory("/torch_prov/a.bin", b"changed")
    assert tprov.fetch_file("memory://torch_prov/a.bin", dest,
                            expected_size=len(payload)) == dest
    assert open(dest, "rb").read() == payload
    assert not os.path.exists(dest + ".tmp")


@pytest.mark.parametrize("kind", ["size", "sha256"])
def test_fetch_file_mismatch_raises(tmp_path, kind):
    _memory("/torch_prov/b.bin", b"payload")
    kw = ({"expected_size": 3} if kind == "size"
          else {"expected_sha256": "0" * 64})
    prev = file_io.set_retry_timebase(lambda: 0.0, lambda d: None)
    try:
        with pytest.raises(tprov.DownloadIntegrityError,
                           match=f"{kind} mismatch"):
            tprov.fetch_file("memory://torch_prov/b.bin",
                             str(tmp_path / "b.bin"), **kw)
    finally:
        file_io.set_retry_timebase(*prev)
    assert not os.path.exists(str(tmp_path / "b.bin"))


def test_load_mnist_fetches_missing_files(tmp_path):
    rs = np.random.RandomState(4)
    src = tmp_path / "src"
    os.makedirs(src)
    for name, arr in (("train-images-idx3-ubyte.gz",
                       rs.randint(0, 256, (3, 28, 28)).astype(np.uint8)),
                      ("train-labels-idx1-ubyte.gz",
                       rs.randint(0, 10, 3).astype(np.uint8))):
        _write_idx(str(src / name), arr, 0x08)
        _memory(f"/torch_mnist/{name}", open(src / name, "rb").read())
    got = tprov.load_mnist(str(tmp_path / "dst"), "train",
                           source="memory://torch_mnist")
    _same_samples(got, jprov.load_mnist(str(src), "train"))
