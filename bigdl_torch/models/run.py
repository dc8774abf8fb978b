"""The model zoo's Train/Test command line.

Counterpart of ``bigdl_tpu/models/run.py`` (reference: each model's scopt
``Train``/``Test`` main, ``models/lenet/Train.scala:35``, ...).  Data comes
from BDRecord shards (``tools/record_generator.py``'s output: dicts of
uint8 pixels rescaled to [0, 1] by dtype, or pickled Samples), or
``--synthetic`` for smoke runs.  The process is the driver.  Every flag
of the reference is here, plus ``--device`` (default ``cuda``; ``cpu``
runs on the host).  As in the reference the model trains unfused in the
default float32 policy.  On the card that policy runs cuDNN's
convolutions in TF32, PyTorch's default (``torch.backends.cudnn.allow_tf32``;
a caller that wants them in float32 sets it to False before :func:`main`).
One process trains on one device, and a world of
several (``BIGDL_TORCH_NUM_PROCESSES`` > 1) forms the Engine's group and
trains data-parallel.

Train::

    python -m bigdl_torch.models.run train --model resnet50 \\
        --data '/data/bdr/train-*' --batch-size 256 --max-epoch 90 \\
        [--checkpoint /ckpt] [--summary-dir /tb] [--validate /data/val] \\
        [--model-save /models/resnet50.bigdl]

Test::

    python -m bigdl_torch.models.run test --model resnet50 \\
        --snapshot /models/resnet50.bigdl --data '/data/bdr/val-*'

Models: ``lenet``, ``vgg`` (VggForCifar10, 32 x 32), ``vgg16``,
``vgg19``, ``resnet`` (ResNet-20 on CIFAR-10, shortcut A), ``resnet50``,
``inception`` (Inception-v1 without its auxiliary heads), ``inception_v2``
(BN-Inception without them), ``alexnet`` (227 x 227), ``transformer``,
``autoencoder`` (trained with ``MSECriterion`` to reconstruct its
input, with no validation, as in the reference) and ``vit`` (the
reference's small ViT: 32 x 32, patch 4, d_model 64, 4 heads of 16, 4
layers); the image models at 224 x 224 but where named, all with the
reference's criteria.  ``--num-experts`` > 0 builds ``transformer`` and
``vit`` with ``parallel/expert.py`` ``MoEFFN`` MLPs, as the reference's
CLI does.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

logger = logging.getLogger(__name__)

#: the reference zoo's names that the port has no model for yet
_NOT_PORTED = ()


def _build_model(name: str, class_num: int, num_experts: int = 0):
    """-> (model, input spec, criterion name), the reference's pairing:
    models ending in LogSoftMax with ClassNLL, logits with CrossEntropy."""
    if name == "lenet":
        from .lenet import LeNet5
        return LeNet5(class_num), (28, 28, 1), "nll"
    if name == "vgg":
        from .vgg import VggForCifar10
        return VggForCifar10(class_num), (32, 32, 3), "nll"
    if name == "vgg16":
        from .vgg import Vgg_16
        return Vgg_16(class_num), (224, 224, 3), "nll"
    if name == "vgg19":
        from .vgg import Vgg_19
        return Vgg_19(class_num), (224, 224, 3), "nll"
    if name == "resnet":
        from .resnet import ResNet
        return ResNet(depth=20, class_num=class_num,
                      dataset="cifar10"), (32, 32, 3), "xent"
    if name == "resnet50":
        from .resnet import ResNet
        return ResNet(depth=50, class_num=class_num,
                      dataset="imagenet"), (224, 224, 3), "xent"
    if name == "inception":
        from .inception import Inception_v1_NoAuxClassifier
        return (Inception_v1_NoAuxClassifier(class_num), (224, 224, 3),
                "nll")
    if name == "inception_v2":
        from .inception import Inception_v2_NoAuxClassifier
        return (Inception_v2_NoAuxClassifier(class_num), (224, 224, 3),
                "nll")
    if name == "alexnet":
        from .alexnet import AlexNet
        return AlexNet(class_num), (227, 227, 3), "nll"
    if name == "autoencoder":
        from .autoencoder import Autoencoder
        return Autoencoder(32), (28, 28, 1), "mse"
    if name == "vit":
        # the reference's small config for the CLI; the ImageNet one is
        # ViT()'s defaults
        from .vit import ViT
        return (ViT(image_size=32, patch_size=4, class_num=class_num,
                    d_model=64, num_heads=4, num_layers=4,
                    num_experts=num_experts),
                (32, 32, 3), "nll")
    if name == "transformer":
        from .transformer_lm import TransformerLM
        vocab = max(class_num, 64)
        seq = 128
        return (TransformerLM(vocab_size=vocab, max_len=seq, d_model=256,
                              num_heads=8, num_layers=4,
                              num_experts=num_experts),
                ("tokens", seq, vocab), "lm")
    raise ValueError(f"unknown model {name!r}")


def build_criterion(crit: str):
    """The criterion of a model's pairing name."""
    from .. import nn
    if crit == "mse":
        return nn.MSECriterion()
    if crit == "nll":
        return nn.ClassNLLCriterion()
    if crit == "lm":  # per-token NLL over [B, T, vocab] log-probs
        return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                           size_average=True)
    return nn.CrossEntropyCriterion()


def _load_samples(path: str, input_hw):
    """BDRecord shards of ``{"data", "label"}`` dicts or Samples ->
    [Sample]; uint8 pixels are divided by 255, float records taken as
    they are."""
    from ..dataset import Sample
    from ..utils.recordio import read_records
    samples = []
    for rec in read_records(path):
        if isinstance(rec, Sample):
            samples.append(rec)
        else:
            raw = np.asarray(rec["data"])
            if raw.dtype == np.uint8:
                data = raw.astype(np.float32) / 255.0
            else:
                data = raw.astype(np.float32)
            samples.append(Sample(data, np.float32(rec["label"])))
    if not samples:
        raise ValueError(f"no records in {path!r}")
    return samples


def _synthetic(input_hw, class_num: int, n: int = 512, seed: int = 0):
    """Separable synthetic data, the reference's: class prototypes from
    seed 0 for every split, noise from ``seed``; ("tokens", seq, vocab)
    gives cyclic token sequences for the LM."""
    from ..dataset import Sample
    if input_hw and input_hw[0] == "tokens":
        _, seq, vocab = input_hw
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            start = int(rng.integers(0, vocab))
            toks = [(start + i) % vocab for i in range(seq + 1)]
            out.append(Sample(np.asarray(toks[:-1], np.int32),
                              np.asarray(toks[1:], np.int32)))
        return out
    protos = np.random.default_rng(0).standard_normal(
        (class_num,) + input_hw)
    rng = np.random.default_rng(seed)
    return [Sample((protos[i % class_num] +
                    rng.standard_normal(input_hw) * 0.1).astype(np.float32),
                   np.float32(i % class_num)) for i in range(n)]


def _device(args):
    """``--device``: ``cuda`` (the current CUDA device; raises without one,
    as every entry point does), ``cpu`` or a named device."""
    return None if args.device == "cuda" else args.device


def _engine(device):
    """The Engine's group where the world has several processes."""
    from ..utils import config
    from ..utils.engine import Engine
    if config.get_int("NUM_PROCESSES", 1) > 1:
        Engine.init(device=device)


def train(args):
    from ..dataset import DataSet, SampleToMiniBatch
    from ..optim import SGD, Adam, Optimizer, Top1Accuracy, Trigger
    from ..visualization import TrainSummary, ValidationSummary

    device = _device(args)
    _engine(device)
    model, input_hw, crit = _build_model(args.model, args.class_num,
                                         args.num_experts)
    samples = (_synthetic(input_hw, args.class_num) if args.synthetic
               else _load_samples(args.data, input_hw))
    if crit == "mse":
        # the autoencoder reconstructs its input, flattened as the model's
        # output is (models/autoencoder/Train.scala); the JAX package's CLI
        # passes the image unflattened, which MSECriterion cannot broadcast
        from ..dataset import Sample
        samples = [Sample(s.feature, np.reshape(s.feature, -1))
                   for s in samples]
    criterion = build_criterion(crit)
    ds = DataSet.array(samples).transform(
        SampleToMiniBatch(args.batch_size, drop_last=True))
    method = (Adam(args.learning_rate) if args.optim == "adam"
              else SGD(args.learning_rate, momentum=args.momentum,
                       weight_decay=args.weight_decay))
    end = Trigger.max_epoch(args.max_epoch)
    if args.max_iteration:
        end = Trigger.or_(end, Trigger.max_iteration(args.max_iteration))
    opt = (Optimizer(model, ds, criterion, device=device)
           .set_optim_method(method)
           .set_end_when(end))
    if args.model_snapshot:
        # --model / --state resume (models/lenet/Train.scala:48-59)
        opt.resume_from(args.model_snapshot, args.state_snapshot)
    if args.checkpoint:
        trig = (Trigger.several_iteration(args.checkpoint_iteration)
                if args.checkpoint_iteration else Trigger.every_epoch())
        opt.set_checkpoint(args.checkpoint, trig,
                           is_overwrite=args.overwrite)
    if args.summary_dir:
        opt.set_train_summary(TrainSummary(args.summary_dir, args.app_name))
    if crit != "mse" and (args.validate or args.synthetic):
        vsamples = (_synthetic(input_hw, args.class_num, n=128, seed=1)
                    if args.synthetic else
                    _load_samples(args.validate, input_hw))
        opt.set_validation(Trigger.every_epoch(), DataSet.array(vsamples),
                           [Top1Accuracy()], batch_size=args.batch_size)
        if args.summary_dir:
            opt.set_validation_summary(
                ValidationSummary(args.summary_dir, args.app_name))
    trained = opt.optimize()
    if args.model_save:
        trained.save(args.model_save)
        logger.info("model saved -> %s", args.model_save)
    return opt


def test(args):
    from .. import nn
    from ..dataset import DataSet
    from ..optim import Evaluator, Top1Accuracy, Top5Accuracy

    device = _device(args)
    _engine(device)
    model = nn.Module.load(args.snapshot, device=device)
    _, input_hw, _crit = _build_model(args.model, args.class_num)
    samples = (_synthetic(input_hw, args.class_num, n=256, seed=1)
               if args.synthetic else _load_samples(args.data, input_hw))
    results = Evaluator(model, device=device).test(
        DataSet.array(samples), [Top1Accuracy(), Top5Accuracy()],
        batch_size=args.batch_size)
    for method, res in results:
        print(f"{method.name}: {res}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="model zoo Train/Test CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for cmd in ("train", "test"):
        p = sub.add_parser(cmd)
        p.add_argument("--model", required=True)
        p.add_argument("--data", help="BDRecord path or glob")
        p.add_argument("--synthetic", action="store_true",
                       help="synthetic data smoke run")
        p.add_argument("--batch-size", type=int, default=128)
        p.add_argument("--class-num", type=int, default=10)
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
        if cmd == "train":
            # the reference Train CLIs' options (models/lenet/Utils.scala,
            # models/inception/Options.scala)
            p.add_argument("--num-experts", type=int, default=0,
                           help="transformer and vit: Switch-style MoE "
                                "FFN with this many experts "
                                "(parallel/expert.py MoEFFN)")
            p.add_argument("--max-epoch", type=int, default=5)
            p.add_argument("--max-iteration", type=int, default=0,
                           help="also stop after N iterations (-i)")
            p.add_argument("--learning-rate", type=float, default=0.01)
            p.add_argument("--momentum", type=float, default=0.9)
            p.add_argument("--weight-decay", type=float, default=0.0)
            p.add_argument("--optim", choices=("sgd", "adam"),
                           default="sgd")
            p.add_argument("--checkpoint")
            p.add_argument("--checkpoint-iteration", type=int, default=0,
                           help="checkpoint every N iterations instead of "
                                "every epoch")
            p.add_argument("--overwrite", action="store_true",
                           help="overwrite checkpoint files "
                                "(--overwriteCheckpoint)")
            p.add_argument("--model-snapshot",
                           help="resume the model from model.<n> (--model)")
            p.add_argument("--state-snapshot",
                           help="resume the method state from "
                                "optimMethod.<n> (--state)")
            p.add_argument("--summary-dir")
            p.add_argument("--app-name", default="bigdl_torch")
            p.add_argument("--validate", help="validation BDRecord path")
            p.add_argument("--model-save", help="save the trained model here")
        else:
            p.add_argument("--snapshot", required=True,
                           help="model file written by Module.save")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if not args.synthetic and not args.data:
        ap.error("need --data or --synthetic")
    return (train if args.cmd == "train" else test)(args)


if __name__ == "__main__":
    main()
