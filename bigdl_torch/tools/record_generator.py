"""Offline ETL: an image-folder tree -> sharded BDRecord files.

Counterpart of ``bigdl_tpu/tools/record_generator.py`` (reference:
``models/utils/ImageNetSeqFileGenerator.scala``).  Each image is decoded
(``dataset/image.py``: ``.npy`` always, other formats through PIL), its
shorter side optionally resized, and stored as ``{"data": uint8 HWC,
"label": float}``, round-robin over the shards (``utils/recordio.py``
``write_records``), so both packages write the same bytes from the same
folder.

Usage::

    python -m bigdl_torch.tools.record_generator \\
        --folder /data/imagenet/train --output /data/bdr/train \\
        --shards 64 [--scale 256] [--parallel 8]

``--from-seq`` reads a folder of Hadoop SequenceFile shards (the
reference's ``ImageNetSeqFileGenerator`` format, ``dataset/seqfile.py``)
instead and copies their records as stored, labels above ``--class-num``
left out::

    python -m bigdl_torch.tools.record_generator --from-seq \\
        --folder /data/imagenet/seq --output /data/bdr/train --shards 64
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def convert(folder: str, output: str, shards: int = 8, scale: int = -1,
            parallel: int = os.cpu_count() or 1, quiet: bool = False):
    """Write ``folder``'s images as shards of ``output``; returns (shard
    paths, record count).  Labels are the class folders' sorted order."""
    from ..dataset.image import _decode_image, _resize_shorter
    from ..utils.recordio import write_records

    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))
    if not classes:
        raise ValueError(f"no class directories under {folder!r}")
    jobs = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(folder, cls)
        for fname in sorted(os.listdir(cdir)):
            jobs.append((os.path.join(cdir, fname), float(label)))

    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)

    def prepare(job):
        path, label = job
        img = _decode_image(path)  # float32 in [0, 1]
        if scale > 0:
            img = _resize_shorter(img, scale)
        # compact uint8 pixels; the loaders rescale by dtype
        data = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        return {"data": data, "label": label}

    n = 0

    def records():
        nonlocal n
        with ThreadPoolExecutor(max_workers=parallel) as pool:
            for rec in pool.map(prepare, jobs, chunksize=16):
                n += 1
                if not quiet and n % 1000 == 0:
                    print(f"{n}/{len(jobs)} records")
                yield rec

    paths = write_records(output, records(), shards=shards)
    if not quiet:
        print(f"wrote {n} records over {shards} shards -> {output}-*")
    return paths, n


def convert_seq(folder: str, output: str, shards: int = 8,
                class_num: int = None, quiet: bool = False):
    """Hadoop SequenceFile shards -> BDRecord shards of ``{"data": uint8
    BGR HWC, "label": float}``; returns (shard paths, record count)."""
    from ..dataset.seqfile import find_seq_files, read_byte_records
    from ..utils.recordio import write_records

    paths = find_seq_files(folder)
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    n = 0

    def records():
        nonlocal n
        for p in paths:
            for rec in read_byte_records(p, class_num):
                n += 1
                yield rec

    out = write_records(output, records(), shards=shards)
    if not quiet:
        print(f"imported {n} records from {len(paths)} .seq files "
              f"-> {output}-*")
    return out, n


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="image folder (or .seq shards, --from-seq) -> sharded "
                    "BDRecord files")
    ap.add_argument("--folder", required=True,
                    help="directory-per-class image tree, or a folder of "
                         "*.seq files with --from-seq")
    ap.add_argument("--output", required=True, help="output shard base path")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--scale", type=int, default=-1,
                    help="resize the shorter side to this (LocalImgReader)")
    ap.add_argument("--parallel", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--from-seq", action="store_true",
                    help="input is Hadoop SequenceFile shards written by "
                         "the reference's ImageNetSeqFileGenerator")
    ap.add_argument("--class-num", type=int, default=None,
                    help="with --from-seq: keep labels <= this")
    args = ap.parse_args(argv)
    if args.from_seq:
        if args.scale != -1 or args.parallel != (os.cpu_count() or 1):
            ap.error("--scale/--parallel apply only to the image-folder "
                     "path; --from-seq copies records as stored")
        return convert_seq(args.folder, args.output, args.shards,
                           args.class_num)
    if args.class_num is not None:
        ap.error("--class-num requires --from-seq")
    return convert(args.folder, args.output, args.shards, args.scale,
                   args.parallel)


if __name__ == "__main__":
    main()
