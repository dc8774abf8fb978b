"""Image records and transformers.

Counterpart of ``bigdl_tpu/dataset/image.py`` (reference
``dataset/image/``: ``LabeledBGRImage``, ``BGRImgCropper``,
``BGRImgRdmCropper``, ``BGRImgNormalizer``, ``BGRImgPixelNormalizer``,
``HFlip``, ``ColorJitter``, ``Lighting``, ``BGRImgToSample``,
``GreyImgNormalizer``, ``LocalImgReader``, ``MTLabeledBGRImgToBatch``).
Images are numpy float32 HWC arrays in RGB order, and every transformer is
numpy on the host, drawing from ``np.random.default_rng(seed)`` as the
reference does, so under the same seeds the port's output is the
reference's bit for bit.  :class:`MTImageToBatch` is the multi-threaded
batcher: slices of each batch augmented in a thread pool and collated by
the native gather kernel (``utils/native.py`` ``gather_rows``).
``.npy`` images always decode; other formats need PIL.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from ..utils.native import gather_rows
from .sample import MiniBatch, Sample
from .transformer import Batcher, Transformer

__all__ = ["LabeledImage", "load_image_folder", "LocalImgReader",
           "ImgCropper", "ImgRdmCropper", "RdmResizedCrop", "ImgNormalizer",
           "ImgPixelNormalizer", "HFlip", "ColorJitter", "Lighting",
           "ImgToSample", "GreyImgNormalizer", "ChannelScaledNormalizer",
           "MTImageToBatch"]


class LabeledImage:
    """One image + float label (reference: dataset/image/LabeledBGRImage.scala)."""

    __slots__ = ("data", "label")

    def __init__(self, data: np.ndarray, label: float = 0.0):
        self.data = data  # (H, W, C) float32
        self.label = label

    @property
    def width(self):
        return self.data.shape[1]

    @property
    def height(self):
        return self.data.shape[0]


def _decode_image(path: str) -> np.ndarray:
    """Decode to float32 HWC RGB in [0, 1].  Uses PIL when available; .npy
    files load directly (the zero-dependency path)."""
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        try:
            from PIL import Image  # optional dependency
        except ImportError as e:
            raise ImportError(
                "decoding non-.npy images requires PIL; convert the images "
                "to .npy or to record files (bigdl_torch.utils.recordio)"
            ) from e
        arr = np.asarray(Image.open(path).convert("RGB"))
    arr = arr.astype(np.float32)
    if arr.max() > 1.5:
        arr /= 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def load_image_folder(path: str) -> List[LabeledImage]:
    """Directory-per-class tree -> records (reference: DataSet.ImageFolder,
    dataset/DataSet.scala:319; labels are assigned by sorted class-dir order)."""
    classes = sorted(d for d in os.listdir(path)
                     if os.path.isdir(os.path.join(path, d)))
    records = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(path, cls)
        for fname in sorted(os.listdir(cdir)):
            records.append(LabeledImage(_decode_image(os.path.join(cdir, fname)),
                                        float(label)))
    return records


class LocalImgReader(Transformer):
    """(path, label) pairs -> LabeledImage, with optional resize-shorter-side
    (reference: dataset/image/LocalImgReader.scala)."""

    def __init__(self, scale_to: int = -1):
        self.scale_to = scale_to

    def __call__(self, it: Iterator) -> Iterator[LabeledImage]:
        for path, label in it:
            img = _decode_image(path)
            if self.scale_to > 0:
                img = _resize_shorter(img, self.scale_to)
            yield LabeledImage(img, label)


def _resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    return _resize_bilinear(img, nh, nw)


def _resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Pure-numpy bilinear resize (align_corners=False convention)."""
    h, w = img.shape[:2]
    if (h, w) == (nh, nw):
        return img
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(img.dtype)


class ImgCropper(Transformer):
    """Center (or fixed-position) crop (reference: BGRImgCropper.scala)."""

    def __init__(self, crop_width: int, crop_height: int):
        self.cw, self.ch = crop_width, crop_height

    def __call__(self, it):
        for img in it:
            h, w = img.data.shape[:2]
            y = (h - self.ch) // 2
            x = (w - self.cw) // 2
            yield LabeledImage(img.data[y:y + self.ch, x:x + self.cw],
                               img.label)


class ImgRdmCropper(Transformer):
    """Random-position crop after optional padding
    (reference: BGRImgRdmCropper.scala)."""

    def __init__(self, crop_width: int, crop_height: int, padding: int = 0,
                 seed: int = 1):
        self.cw, self.ch, self.padding = crop_width, crop_height, padding
        self.rng = np.random.default_rng(seed)

    def __call__(self, it):
        for img in it:
            data = img.data
            if self.padding > 0:
                p = self.padding
                data = np.pad(data, ((p, p), (p, p), (0, 0)))
            h, w = data.shape[:2]
            y = self.rng.integers(0, h - self.ch + 1)
            x = self.rng.integers(0, w - self.cw + 1)
            yield LabeledImage(data[y:y + self.ch, x:x + self.cw], img.label)


class RdmResizedCrop(Transformer):
    """Random-area crop + resize, the Inception-style augmentation
    (reference: the random crop in models/inception/ImageNet2012.scala)."""

    def __init__(self, width: int, height: int, area=(0.08, 1.0),
                 ratio=(3 / 4, 4 / 3), seed: int = 1):
        self.w, self.h, self.area, self.ratio = width, height, area, ratio
        self.rng = np.random.default_rng(seed)

    def __call__(self, it):
        for img in it:
            h, w = img.data.shape[:2]
            for _ in range(10):
                a = self.rng.uniform(*self.area) * h * w
                r = self.rng.uniform(*self.ratio)
                ch = int(round(np.sqrt(a / r)))
                cw = int(round(np.sqrt(a * r)))
                if ch <= h and cw <= w:
                    y = self.rng.integers(0, h - ch + 1)
                    x = self.rng.integers(0, w - cw + 1)
                    crop = img.data[y:y + ch, x:x + cw]
                    break
            else:
                crop = img.data
            yield LabeledImage(_resize_bilinear(crop, self.h, self.w),
                               img.label)


class ImgNormalizer(Transformer):
    """Per-channel (x - mean) / std (reference: BGRImgNormalizer.scala)."""

    def __init__(self, means, stds):
        self.means = np.asarray(means, np.float32)
        self.stds = np.asarray(stds, np.float32)

    def __call__(self, it):
        for img in it:
            yield LabeledImage((img.data - self.means) / self.stds, img.label)


GreyImgNormalizer = ImgNormalizer  # single-channel case is identical


class ImgPixelNormalizer(Transformer):
    """Subtract a full per-pixel mean image (reference:
    BGRImgPixelNormalizer.scala, used by the ImageNet mean file)."""

    def __init__(self, mean_image: np.ndarray):
        self.mean = np.asarray(mean_image, np.float32)

    def __call__(self, it):
        for img in it:
            yield LabeledImage(img.data - self.mean, img.label)


class ChannelScaledNormalizer(Transformer):
    """x * scale - mean, Caffe-style (reference parity helper)."""

    def __init__(self, scale: float = 1.0, means=0.0):
        self.scale = scale
        self.means = np.asarray(means, np.float32)

    def __call__(self, it):
        for img in it:
            yield LabeledImage(img.data * self.scale - self.means, img.label)


class HFlip(Transformer):
    """Random horizontal flip (reference: dataset/image/HFlip.scala)."""

    def __init__(self, threshold: float = 0.5, seed: int = 1):
        self.threshold = threshold
        self.rng = np.random.default_rng(seed)

    def __call__(self, it):
        for img in it:
            if self.rng.random() < self.threshold:
                yield LabeledImage(img.data[:, ::-1].copy(), img.label)
            else:
                yield img


class ColorJitter(Transformer):
    """Random brightness/contrast/saturation in random order
    (reference: dataset/image/ColorJitter.scala)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 1):
        self.b, self.c, self.s = brightness, contrast, saturation
        self.rng = np.random.default_rng(seed)

    def _grayscale(self, x):
        g = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        return g[..., None]

    def __call__(self, it):
        for img in it:
            x = img.data
            ops = [self._brightness, self._contrast, self._saturation]
            self.rng.shuffle(ops)
            for op in ops:
                x = op(x)
            yield LabeledImage(x, img.label)

    def _brightness(self, x):
        alpha = 1.0 + self.rng.uniform(-self.b, self.b)
        return x * alpha

    def _contrast(self, x):
        alpha = 1.0 + self.rng.uniform(-self.c, self.c)
        mean = self._grayscale(x).mean()
        return x * alpha + mean * (1 - alpha)

    def _saturation(self, x):
        alpha = 1.0 + self.rng.uniform(-self.s, self.s)
        return x * alpha + self._grayscale(x) * (1 - alpha)


class Lighting(Transformer):
    """AlexNet-style PCA lighting noise (reference:
    dataset/image/Lighting.scala, with the ImageNet eigen decomposition)."""

    EIGVAL = np.asarray([0.2175, 0.0188, 0.0045], np.float32)
    EIGVEC = np.asarray([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alphastd: float = 0.1, seed: int = 1):
        self.alphastd = alphastd
        self.rng = np.random.default_rng(seed)

    def __call__(self, it):
        for img in it:
            alpha = self.rng.normal(0, self.alphastd, 3).astype(np.float32)
            noise = (self.EIGVEC * alpha) @ self.EIGVAL
            yield LabeledImage(img.data + noise, img.label)


class MTImageToBatch(Batcher):
    """Multi-threaded image batcher: parallel decode/augment feeding one
    collation (reference: dataset/image/MTLabeledBGRImgToBatch.scala,
    parallelism width Engine.coreNumber).

    Each incoming batch-worth of LabeledImages is split into contiguous
    slices across `num_threads` workers; every worker runs its own CLONE
    of the per-image `transformer` chain over its slice (the reference
    clones transformers per thread, Transformer.scala:56) and the
    transformed images are collated into one MiniBatch with the native
    parallel gather kernel when built (csrc/hostops.cc).  Images in,
    MiniBatches out — compose it after a reader:
    ``LocalImgReader(256) >> MTImageToBatch(128, crop >> flip >> norm)``.

    The per-image transformer must map one image to one image (true of
    every crop/flip/jitter/normalize transformer here); a count change
    raises instead of silently emitting wrong-size batches.  Worker
    clones start from the clone-time RNG state, which no batch advances:
    the draws depend on the thread count and slice boundaries, and every
    batch's k-th slice repeats the same draws.  The port computes what the
    reference computes; ``ROADMAP.md`` queue C records it as a defect of
    the reference.  Use the sequential chain when the draws matter.
    """

    def __init__(self, batch_size: int, transformer: Transformer = None,
                 to_chw: bool = False, num_threads: Optional[int] = None,
                 drop_last: bool = False, pad_last: bool = False):
        self.batch_size = batch_size
        self.transformer = transformer
        self.to_chw = to_chw
        self.num_threads = num_threads or min(8, os.cpu_count() or 1)
        self.drop_last = drop_last
        self.pad_last = pad_last

    def _slice_task(self, images):
        # a fresh clone of the never-advanced chain for every slice of
        # every batch: each batch's k-th slice replays the same random
        # draws, as in the reference (ROADMAP.md queue C)
        tf = (self.transformer.clone_transformer()
              if self.transformer is not None else None)
        out = list(tf(iter(images))) if tf is not None else images
        if len(out) != len(images):
            raise ValueError(
                "MTImageToBatch requires a 1:1 image transformer (slice "
                f"of {len(images)} became {len(out)}); apply filtering "
                "transformers upstream of the batcher")
        feats, labels = [], []
        for img in out:
            data = img.data
            if self.to_chw:
                data = np.transpose(data, (2, 0, 1))
            feats.append(np.ascontiguousarray(data))
            labels.append(np.int32(img.label))
        return feats, labels

    def __call__(self, it):
        from ..utils.thread_pool import ThreadPool

        pool = ThreadPool(self.num_threads)
        try:
            buf = []
            for img in it:
                buf.append(img)
                if len(buf) == self.batch_size:
                    yield self._assemble(pool, buf)
                    buf = []
            if buf and not self.drop_last:
                valid = len(buf)
                if self.pad_last:
                    while len(buf) < self.batch_size:
                        buf.append(buf[-1])
                b = self._assemble(pool, buf)
                b.valid = valid
                yield b
        finally:
            pool.shutdown()

    def _assemble(self, pool, images):
        n = max(1, min(self.num_threads, len(images)))
        per = (len(images) + n - 1) // n
        slices = [images[i:i + per] for i in range(0, len(images), per)]
        parts = pool.invoke_and_wait(
            [lambda s=s: self._slice_task(s) for s in slices])
        feats = [f for fs, _ in parts for f in fs]
        labels = [l for _, ls in parts for l in ls]
        # gather_rows for BOTH, like SampleToMiniBatch._batch — batches are
        # byte-identical to the sequential ImgToSample >> SampleToMiniBatch
        # chain (drop-in parity)
        return MiniBatch(gather_rows(feats), gather_rows(labels))


class ImgToSample(Transformer):
    """LabeledImage -> Sample (reference: BGRImgToSample.scala).  Labels come
    out 0-based int32 (the reference emits 1-based floats)."""

    def __init__(self, to_chw: bool = False):
        self.to_chw = to_chw  # NHWC is canonical here; CHW for interop only

    def __call__(self, it):
        for img in it:
            data = img.data
            if self.to_chw:
                data = np.transpose(data, (2, 0, 1))
            yield Sample(np.ascontiguousarray(data), np.int32(img.label))
