"""ModelValidator: load a pretrained model in any supported format and
evaluate it.

Counterpart of ``bigdl_tpu/tools/model_validator.py`` (reference:
``example/loadmodel/{ModelValidator,AlexNet}.scala``, a CLI that loads
Caffe, Torch and BigDL models and reports top-1 and top-5 on a validation
set).  Formats: bigdl (the JVM object stream, or the port's own
``Module.save`` file), caffe (.caffemodel), torch (.t7) and tf (frozen
GraphDef), all through ``interop/``; the model is built on ``--device``
(the CUDA device by default; it raises without one).

Usage::

    python -m bigdl_torch.tools.model_validator \\
        --model-type caffe --model /m.caffemodel \\
        --data /data/val.bdr --batch-size 128 [--device cpu]
"""

from __future__ import annotations

import argparse
import json


def load_model(model_type: str, path: str, device=None):
    """The model in ``path`` on ``device`` (default the CUDA device)."""
    if model_type == "bigdl":
        # "bigdl" covers both native formats: a file written by the JVM
        # BigDL is a Java object-serialization stream (magic 0xACED, the
        # reference's Module.save, utils/File.scala:25); one written by
        # the port's Module.save is its framed module file.  Read through
        # file_io so remote paths work.
        from ..utils import file_io
        local = file_io._strip_file_scheme(path)
        data = file_io.get_filesystem(local).read_bytes(local)
        if data[:2] == b"\xac\xed":
            from ..interop import bigdl as bigdl_fmt
            return bigdl_fmt.load_bytes(data, device)
        from ..nn.module import Module
        return Module.load(path, device=device)
    if model_type == "caffe":
        from ..interop import load_caffe
        return load_caffe(path, device=device)[0]
    if model_type == "torch":
        from ..interop import load_torch_module
        return load_torch_module(path, device=device)[0]
    if model_type == "tf":
        from ..interop import load_tf
        return load_tf(path, device=device)[0]
    raise ValueError(f"unknown model type {model_type!r}")


def validate(model_type: str, model_path: str, data_path: str,
             batch_size: int = 128, device=None):
    """Top-1 and Top-5 of the model over BDRecord shards:
    {method name: {"accuracy", "count"}}."""
    from ..dataset import DataSet
    from ..models.run import _engine, _load_samples
    from ..optim import Evaluator, Top1Accuracy, Top5Accuracy

    _engine(device)
    model = load_model(model_type, model_path, device)
    samples = _load_samples(data_path, None)
    results = Evaluator(model, device=device).test(
        DataSet.array(samples), [Top1Accuracy(), Top5Accuracy()],
        batch_size=batch_size)
    out = {}
    for method, res in results:
        acc, n = res.result()
        out[method.name] = {"accuracy": acc, "count": n}
        print(f"{method.name}: {res}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="load + evaluate a pretrained model "
                    "(reference: example/loadmodel/ModelValidator.scala)")
    ap.add_argument("--model-type", required=True,
                    choices=("bigdl", "caffe", "torch", "tf"))
    ap.add_argument("--model", required=True)
    ap.add_argument("--data", required=True, help="BDRecord path/glob")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line instead of text")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without one), cpu, or a "
                         "named device")
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else args.device
    out = validate(args.model_type, args.model, args.data, args.batch_size,
                   device)
    if args.json:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
