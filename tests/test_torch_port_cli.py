"""The port's Train/Test command line (``models/run.py``) against the JAX
package's, on the CPU.

- LeNet-5 on the reference's synthetic MNIST: the reference's CLI trains
  one epoch with a checkpoint; each package's CLI resumes from that
  snapshot for a second epoch (the port with ``--device cpu``).  The
  port's resumed losses (its train summary's Loss, every iteration) stay
  within 2e-3 of the reference's (float32 sums in another order, bf16
  gradient wire); they equal the port's library path (``Optimizer`` built
  by hand with the same pieces) bit for bit.
- ``--model-save`` then ``test --snapshot``: Top1 and Top5 equal
  ``Evaluator`` on the live trained model, bit for bit.
- ``--model resnet`` (ResNet-20, shortcut A) trains 2 iterations from
  BDRecord shards of uint8 images (``_load_samples`` rescales them as the
  reference's does, sample for sample).
- The names the port has no model for raise, naming their queue item.
"""

import os

import numpy as np
import pytest
import torch

from bigdl_tpu.models import run as jrun
from bigdl_tpu.utils import recordio as jrec

from bigdl_torch.models import run as trun
from bigdl_torch.utils import file_io
from bigdl_torch.visualization.reader import read_scalar

LOSS_TOL = 2e-3
BATCH = "64"


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    from bigdl_tpu.common import get_default_rng
    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _losses(summary_dir):
    """The train summary's Loss values, by step, under its one app."""
    (app,) = os.listdir(summary_dir)
    path = os.path.join(summary_dir, app, "train")
    return [v for _, v, _ in sorted(read_scalar(path, "Loss"))]


def test_lenet_resumed_from_reference_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    jrun.main(["train", "--model", "lenet", "--synthetic", "--batch-size",
               BATCH, "--max-epoch", "1", "--checkpoint", ckpt])
    mp, op, n = file_io.latest_checkpoint(ckpt)
    assert n == 8
    resume = ["--model-snapshot", mp, "--state-snapshot", op]
    common = ["train", "--model", "lenet", "--synthetic", "--batch-size",
              BATCH, "--max-epoch", "2"] + resume
    jopt = jrun.main(common + ["--summary-dir", str(tmp_path / "j")])
    topt = trun.main(common + ["--summary-dir", str(tmp_path / "t"),
                               "--device", "cpu"])
    jopt.train_summary.flush()
    topt.train_summary.flush()
    want = _losses(str(tmp_path / "j"))
    got = _losses(str(tmp_path / "t"))
    assert len(got) == len(want) == 8
    assert np.max(np.abs(np.subtract(got, want))) <= LOSS_TOL, (got, want)

    # the library path, by hand
    from bigdl_torch import nn
    from bigdl_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_torch.models import LeNet5
    from bigdl_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
    from bigdl_torch.visualization import TrainSummary
    ds = DataSet.array(trun._synthetic((28, 28, 1), 10)).transform(
        SampleToMiniBatch(int(BATCH), drop_last=True))
    opt = Optimizer(LeNet5(10), ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(0.01, momentum=0.9, weight_decay=0.0))
    opt.set_end_when(Trigger.max_epoch(2)).resume_from(mp, op)
    opt.set_train_summary(TrainSummary(str(tmp_path / "lib"), "bigdl_torch"))
    opt.set_validation(Trigger.every_epoch(), DataSet.array(
        trun._synthetic((28, 28, 1), 10, n=128, seed=1)), [Top1Accuracy()],
        batch_size=int(BATCH))
    opt.optimize()
    opt.train_summary.flush()
    assert _losses(str(tmp_path / "lib")) == got
    for a, b in zip(opt.model.parameters(), topt.model.parameters()):
        assert torch.equal(a, b)


def test_model_save_then_test(tmp_path, capsys):
    m = str(tmp_path / "lenet.bigdl")
    opt = trun.main(["train", "--model", "lenet", "--synthetic",
                     "--batch-size", BATCH, "--max-iteration", "3",
                     "--device", "cpu", "--model-save", m])
    results = trun.main(["test", "--model", "lenet", "--synthetic",
                         "--batch-size", BATCH, "--snapshot", m,
                         "--device", "cpu"])
    from bigdl_torch.dataset import DataSet
    from bigdl_torch.optim import Evaluator, Top1Accuracy, Top5Accuracy
    live = Evaluator(opt.model, device="cpu").test(
        DataSet.array(trun._synthetic((28, 28, 1), 10, n=256, seed=1)),
        [Top1Accuracy(), Top5Accuracy()], batch_size=int(BATCH))
    assert [(r.correct, r.count) for _, r in results] == \
        [(r.correct, r.count) for _, r in live]
    assert "Top1Accuracy" in capsys.readouterr().out


def test_resnet20_from_shards(tmp_path):
    rs = np.random.RandomState(2)
    recs = [{"data": rs.randint(0, 256, (32, 32, 3)).astype(np.uint8),
             "label": float(i % 10)} for i in range(16)]
    jrec.write_records(str(tmp_path / "s"), recs, shards=2)
    pattern = str(tmp_path / "s-*")
    got = trun._load_samples(pattern, (32, 32, 3))
    want = jrun._load_samples(pattern, (32, 32, 3))
    for a, b in zip(got, want):
        assert np.array_equal(a.feature, b.feature)
        assert a.label == b.label and a.label.dtype == b.label.dtype
    opt = trun.main(["train", "--model", "resnet", "--data", pattern,
                     "--batch-size", "8", "--max-iteration", "2",
                     "--device", "cpu"])
    assert opt.optim_method.hyper["neval"] == 3
    assert np.isfinite(opt.optim_method.hyper["loss"])


@pytest.mark.parametrize("name,item", [("vgg", "item 7"), ("vit", "item 7"),
                                       ("alexnet", "item 7")])
def test_unported_models_raise(name, item):
    """A name the port has no model for raises, naming its item; ``vgg``,
    ``alexnet`` and ``vit``, ported since, build with the reference's
    input spec and criterion."""
    if name in trun._NOT_PORTED:
        with pytest.raises(NotImplementedError, match=item):
            trun._build_model(name, 10)
    else:
        assert trun._build_model(name, 10)[1:] == \
            jrun._build_model(name, 10)[1:]
    # the MoE variant builds, as the reference's does
    moe, spec, crit = trun._build_model("transformer", 10, num_experts=4)
    assert (spec, crit) == jrun._build_model("transformer", 10,
                                             num_experts=4)[1:]
    assert sum(type(m).__name__ == "MoEFFN" for m in moe.modules()) == 4
