"""The port's image augmentation and batchers against the JAX package's,
on the CPU.  Both are numpy on the host with the same seeds, so every
comparison here is bit for bit (``np.array_equal`` with equal dtypes).

- Every image transformer of ``dataset/image.py`` over seeded images of
  mixed sizes, alone and chained with ``>>``; ``load_image_folder`` and
  ``LocalImgReader`` over a folder of ``.npy`` images; ``DataSet.
  image_folder``; ``tools/record_generator.py`` ``convert`` (the shards'
  bytes).
- ``MTImageToBatch`` at 1 and 3 threads, padded and dropped last
  batches.  The reference's repeated draws: its k-th slice clones the
  same never-advanced chain for every batch, so two batches of the same
  images are equal, in both packages (``ROADMAP.md`` queue C records it
  as a defect of the reference; the port keeps it on purpose).
- ``SampleToMiniBatch`` with ``PaddingParam`` and ``FixedLength``,
  multi-tensor Samples, ``MiniBatch.slice``; ``MTSampleToMiniBatch``
  (with its own repeated draws); ``DataSet.sorted_array`` and
  ``group_size``.
"""

import os

import numpy as np
import pytest

from bigdl_tpu.dataset import FixedLength as JFixedLength
from bigdl_tpu.dataset import MTSampleToMiniBatch as JMTS
from bigdl_tpu.dataset import PaddingParam as JPaddingParam
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToMiniBatch as JS2B
from bigdl_tpu.dataset import image as jimg
from bigdl_tpu.tools import record_generator as jgen

from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import FixedLength as TFixedLength
from bigdl_torch.dataset import MTSampleToMiniBatch as TMTS
from bigdl_torch.dataset import PaddingParam as TPaddingParam
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.dataset import SampleToMiniBatch as TS2B
from bigdl_torch.dataset import image as timg
from bigdl_torch.tools import record_generator as tgen

MEANS, STDS = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _images(mod, n=7, seed=0):
    rs = np.random.RandomState(seed)
    return [mod.LabeledImage(
        rs.uniform(0, 1, (12 + i % 4, 14 + 2 * (i % 3), 3))
        .astype(np.float32), float(i % 3)) for i in range(n)]


def _eq(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _chain(mod, kind, seed=3):
    """(transformer, or a callable building one) for each case."""
    return {
        "crop": lambda: mod.ImgCropper(8, 6),
        "rdm_crop": lambda: mod.ImgRdmCropper(8, 8, padding=2, seed=seed),
        "rdm_resized": lambda: mod.RdmResizedCrop(9, 7, seed=seed),
        "norm": lambda: mod.ImgNormalizer(MEANS, STDS),
        "pixel_norm": lambda: mod.ImgPixelNormalizer(
            np.full((12, 14, 3), 0.25, np.float32)),
        "channel_scaled": lambda: mod.ChannelScaledNormalizer(
            255.0, (104.0, 117.0, 123.0)),
        "hflip": lambda: mod.HFlip(seed=seed),
        "jitter": lambda: mod.ColorJitter(seed=seed),
        "lighting": lambda: mod.Lighting(seed=seed),
        "chain": lambda: (mod.RdmResizedCrop(10, 10, seed=seed)
                          >> mod.HFlip(seed=seed + 1)
                          >> mod.ColorJitter(seed=seed + 2)
                          >> mod.Lighting(seed=seed + 3)
                          >> mod.ImgNormalizer(MEANS, STDS)),
    }[kind]()


KINDS = ["crop", "rdm_crop", "rdm_resized", "norm", "pixel_norm",
         "channel_scaled", "hflip", "jitter", "lighting", "chain"]


@pytest.mark.parametrize("kind", KINDS)
def test_image_transformer_like_reference(kind):
    def run(mod):
        imgs = _images(mod)
        if kind == "pixel_norm":
            imgs = [mod.LabeledImage(i.data[:12, :14], i.label)
                    for i in imgs]
        tf = _chain(mod, kind)
        out = list(tf(iter(imgs)))
        out += list(tf(iter(imgs)))     # the generators advance
        return out
    for a, b in zip(run(timg), run(jimg)):
        _eq(a.data, b.data)
        assert a.label == b.label


@pytest.mark.parametrize("to_chw", [False, True])
def test_img_to_sample_like_reference(to_chw):
    t = list(timg.ImgToSample(to_chw)(iter(_images(timg))))
    j = list(jimg.ImgToSample(to_chw)(iter(_images(jimg))))
    for a, b in zip(t, j):
        _eq(a.feature, b.feature)
        _eq(np.asarray(a.label), np.asarray(b.label))


def _folder(root, n=10, ext="npy"):
    rs = np.random.RandomState(4)
    for i in range(n):
        d = root / f"class_{i % 3}"
        d.mkdir(parents=True, exist_ok=True)
        img = rs.randint(0, 256, (16 + i % 2 * 4, 20, 3)).astype(np.uint8)
        np.save(d / f"img_{i:03d}.npy", img)
    return str(root)


def test_image_folder_reader_and_etl_like_reference(tmp_path):
    folder = _folder(tmp_path / "imgs")
    t = timg.load_image_folder(folder)
    j = jimg.load_image_folder(folder)
    assert [i.label for i in t] == [i.label for i in j]
    for a, b in zip(t, j):
        _eq(a.data, b.data)
    assert [r.label for r in TDataSet.image_folder(folder).records] == \
        [i.label for i in j]
    pairs = [(os.path.join(folder, "class_0", f), 0.0)
             for f in sorted(os.listdir(os.path.join(folder, "class_0")))]
    for a, b in zip(timg.LocalImgReader(12)(iter(pairs)),
                    jimg.LocalImgReader(12)(iter(pairs))):
        _eq(a.data, b.data)
    for scale in (-1, 12):
        tp, tn = tgen.convert(folder, str(tmp_path / f"t{scale}" / "s"),
                              shards=3, scale=scale, parallel=2, quiet=True)
        jp, jn = jgen.convert(folder, str(tmp_path / f"j{scale}" / "s"),
                              shards=3, scale=scale, parallel=2, quiet=True)
        assert tn == jn == 10
        assert [open(p, "rb").read() for p in tp] == \
            [open(p, "rb").read() for p in jp]
    # --from-seq: SequenceFile shards to the same BDRecord bytes
    from bigdl_tpu.dataset import seqfile as jseq
    seqdir = tmp_path / "seq"
    seqdir.mkdir()
    rs = np.random.RandomState(9)
    for k in range(2):
        jseq.write_seq_file(str(seqdir / f"part-{k}.seq"), [
            (f"img{k}{i}", i % 4, rs.randint(0, 256, (5, 6, 3)))
            for i in range(7)], sync_interval=3)
    tp, tn = tgen.main(["--folder", str(seqdir), "--output",
                        str(tmp_path / "ts" / "s"), "--shards", "3",
                        "--from-seq", "--class-num", "2"])
    (tmp_path / "js").mkdir()   # the reference's writer makes no folder
    jp, jn = jgen.convert_seq(str(seqdir), str(tmp_path / "js" / "s"),
                              shards=3, class_num=2, quiet=True)
    assert tn == jn == 12
    assert [open(p, "rb").read() for p in tp] == \
        [open(p, "rb").read() for p in jp]


def _mt_batches(mod, threads, bs=4, n=10, pad_last=False, drop_last=False):
    imgs = _images(mod, n=n, seed=1)
    chain = (mod.RdmResizedCrop(8, 8, seed=5) >> mod.HFlip(seed=6)
             >> mod.ColorJitter(seed=7) >> mod.Lighting(seed=8)
             >> mod.ImgNormalizer(MEANS, STDS))
    b = mod.MTImageToBatch(bs, chain, num_threads=threads,
                           pad_last=pad_last, drop_last=drop_last)
    return list(b(iter(imgs)))


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("last", ["keep", "pad", "drop"])
def test_mt_image_to_batch_like_reference(threads, last):
    kw = dict(pad_last=last == "pad", drop_last=last == "drop")
    t = _mt_batches(timg, threads, **kw)
    j = _mt_batches(jimg, threads, **kw)
    assert len(t) == len(j) == (2 if last == "drop" else 3)
    for a, b in zip(t, j):
        _eq(a.input, b.input)
        _eq(a.target, b.target)
        assert a.valid == b.valid


@pytest.mark.parametrize("mod", [timg, jimg], ids=["torch", "jax"])
def test_mt_image_to_batch_repeats_its_draws(mod):
    """The reference's defect, kept: the same 8 images twice give two
    equal batches, where a batcher advancing its generators would not."""
    imgs = _images(mod, n=8, seed=2)
    imgs = [mod.LabeledImage(i.data[:12, :14], i.label) for i in imgs]
    chain = mod.RdmResizedCrop(10, 10, seed=1) >> mod.HFlip(seed=2)
    b1, b2 = list(mod.MTImageToBatch(8, chain, num_threads=2)(
        iter(imgs + imgs)))
    assert np.array_equal(b1.input, b2.input)
    seq = list(chain(iter(imgs + imgs)))
    assert not np.array_equal(np.stack([i.data for i in seq[:8]]),
                              np.stack([i.data for i in seq[8:]]))


def _seq_samples(S, n=7, seed=0, multi=False):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        f = rs.standard_normal((2 + i % 4, 3)).astype(np.float32)
        lab = rs.randint(0, 5, (1 + i % 3,)).astype(np.int32)
        if multi:
            out.append(S([f, np.float32(i) * np.ones(2, np.float32)],
                         [lab, np.full((1,), i, np.int32)]))
        else:
            out.append(S(f, lab))
    return out


def _bat_eq(a, b):
    if isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _bat_eq(x, y)
    else:
        _eq(a, b)


PADS = {"none": lambda m: (None, None),
        "pad": lambda m: (m[0](-1.0), m[0](7)),
        "fixed": lambda m: (m[1](5, 2.0), m[1](2))}


@pytest.mark.parametrize("pad", list(PADS))
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("mt", [False, True])
def test_sample_to_minibatch_like_reference(pad, multi, mt):
    def run(S, S2B, MTS, params):
        fp, lp = PADS[pad](params)
        if multi and pad == "none":
            fp = lp = None
        samples = _seq_samples(S, multi=multi)
        if mt:
            b = MTS(3, None, fp, lp, pad_last=True, num_threads=2)
        else:
            b = S2B(3, fp, lp, pad_last=True)
        return list(b(iter(samples)))
    t = run(TSample, TS2B, TMTS, (TPaddingParam, TFixedLength))
    j = run(JSample, JS2B, JMTS, (JPaddingParam, JFixedLength))
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        _bat_eq(a.input, b.input)
        _bat_eq(a.target, b.target)
        assert a.valid == b.valid and a.size() == b.size()
        _bat_eq(a.slice(1, 2).input, b.slice(1, 2).input)


@pytest.mark.parametrize("kind", ["mt_image", "mt_sample"])
def test_accumulation_check_finds_mt_batchers(kind):
    """``set_gradient_accumulation`` checks every batcher of the chain at
    ``optimize()``: the MT batchers too, not only ``SampleToMiniBatch``."""
    import bigdl_torch.nn as tnn
    from bigdl_torch.optim import ConfigurationError, Optimizer
    if kind == "mt_image":
        ds = TDataSet.array(_images(timg, n=12)).transform(
            timg.MTImageToBatch(6, timg.ImgCropper(8, 8), drop_last=True))
    else:
        ds = TDataSet.array(_seq_samples(TSample, n=12)).transform(
            TMTS(6, None, TPaddingParam(), drop_last=True))
    opt = Optimizer(tnn.Linear(3, 2), ds, tnn.CrossEntropyCriterion(),
                    device="cpu").set_gradient_accumulation(4)
    with pytest.raises(ConfigurationError, match="not divisible"):
        opt.optimize()
