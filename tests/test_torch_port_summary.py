"""Training and validation summaries of the port against the JAX
package, on the CPU.

- The messages: scalar and histogram summaries and events encode to the
  reference's bytes; ``masked_crc32c`` is the reference's.
- Event files: each package's reader reads the other's files (scalars
  and histograms).
- The Optimizer: ``set_train_summary`` writes Loss (the losses the loop
  observed, bit for bit as float32), LearningRate and Throughput at every
  iteration, parameter histograms under the ``"Parameters"`` trigger with
  the reference's tag names (the param-tree paths), and
  ``set_validation_summary`` each validation result; both packages' runs
  of the same LeNet-5 steps write the same tags at the same steps, their
  losses within 2e-3.
"""

import numpy as np
import pytest

import jax
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu import visualization as jvis
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import LeNet5 as JLeNet5
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Top1Accuracy as JTop1
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.utils.recordio import masked_crc32c as jcrc
from bigdl_tpu.visualization import proto as jproto
from bigdl_tpu.visualization import reader as jreader

import bigdl_torch.nn as tnn
from bigdl_torch import visualization as tvis
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import LeNet5
from bigdl_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
from bigdl_torch.utils.convert import load_reference_tree
from bigdl_torch.utils.crc32c import masked_crc32c
from bigdl_torch.visualization import proto as tproto
from bigdl_torch.visualization import reader as treader


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


@pytest.mark.parametrize("data", [b"", b"a", b"hello summary" * 7,
                                  bytes(range(256))])
def test_masked_crc_like_reference(data):
    assert masked_crc32c(data) == jcrc(data)


def test_messages_encode_like_reference():
    vals = np.random.RandomState(0).standard_normal(300) * 3
    assert tproto.scalar_summary("Loss", 0.25) == \
        jproto.scalar_summary("Loss", 0.25)
    assert tproto.histogram_summary("0/weight", vals) == \
        jproto.histogram_summary("0/weight", vals)
    summ = tproto.scalar_summary("x", -1.5)
    assert tproto.event_bytes(12.5, 7, summ) == \
        jproto.event_bytes(12.5, 7, summ)
    assert tproto.parse_event(jproto.event_bytes(1.0, 3, summ)) == \
        jproto.parse_event(tproto.event_bytes(1.0, 3, summ))


def _write(vis, root):
    s = vis.TrainSummary(str(root), "app")
    for k in range(1, 4):
        s.add_scalar("Loss", 1.0 / k, k)
    s.add_histogram("0/weight", np.arange(10.0), 3)
    s.close()
    return s.summary_dir


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_event_files_read_across_packages(writer, tmp_path):
    d = _write(tvis if writer == "port" else jvis, tmp_path)
    for rd in (treader, jreader):
        got = rd.read_scalar(d, "Loss")
        assert [(s, v) for s, v, _ in got] == \
            [(k, np.float32(1.0 / k)) for k in (1, 2, 3)]
    evs = [list(rd.list_events(d)) for rd in (treader, jreader)]
    for a, b in zip(*evs):
        assert {k: v for k, v in a.items() if k != "wall_time"} == \
            {k: v for k, v in b.items() if k != "wall_time"}
    histos = [v["histo"] for ev in evs[0] for v in ev["values"]
              if v["histo"] is not None]
    assert len(histos) == 1 and histos[0]["num"] == 10.0


def test_summary_trigger_names():
    s = tvis.TrainSummary("/nonexistent-never-written", "app")
    s.set_summary_trigger("Parameters", Trigger.several_iteration(2))
    assert s.get_summary_trigger("Parameters") is not None
    assert s.get_summary_trigger("Loss") is None
    with pytest.raises(ValueError):
        s.set_summary_trigger("Gradients", Trigger.every_epoch())


def _every(n, Trigger):
    return Trigger(lambda st: (st["neval"]) % n == 0, f"every{n}")


def test_optimizer_summaries_like_reference(tmp_path):
    JEngine.init()
    rs = np.random.RandomState(0)
    x = rs.normal(0, 0.1, (64, 28, 28)).astype(np.float32)
    y = rs.randint(0, 10, 64).astype(np.int32)
    jm = JLeNet5(10).build(jax.random.key(0))
    tm = LeNet5(10).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    runs = {}
    for name, (model, Opt, Samp, DS, Meth, Trig, Top1, vis, crit, kw) in {
            "ref": (jm, JOptimizer, JSample, JDataSet, JSGD, JTrigger, JTop1,
                    jvis, jnn, {}),
            "port": (tm, Optimizer, Sample, DataSet, SGD, Trigger,
                     Top1Accuracy, tvis, tnn, {"device": "cpu"})}.items():
        seen = {}
        samples = [Samp.from_ndarray(x[i], y[i]) for i in range(64)]
        opt = Opt(model, DS.array(samples), crit.ClassNLLCriterion(),
                  batch_size=16, **kw)
        opt.set_optim_method(Meth(0.05))
        train = vis.TrainSummary(str(tmp_path / name), "lenet")
        train.set_summary_trigger("Parameters", _every(3, Trig))
        val = vis.ValidationSummary(str(tmp_path / name), "lenet")
        opt.set_train_summary(train).set_validation_summary(val)
        opt.set_validation(Trig.several_iteration(2), samples[:32], [Top1()],
                           16)

        def end(st, seen=seen):
            if st["neval"] > 1:
                seen[st["neval"] - 1] = st["loss"]
            return st["neval"] > 6
        opt.set_end_when(Trig(end, "end")).optimize()
        train.close()
        val.close()
        runs[name] = ([seen[k] for k in sorted(seen)], train.summary_dir,
                      val.summary_dir)
    (jseen, jt, jv), (tseen, tt, tv) = runs["ref"], runs["port"]
    tl = treader.read_scalar(tt, "Loss")
    assert [s for s, _, _ in tl] == list(range(1, 7))
    assert [v for _, v, _ in tl] == [float(np.float32(v)) for v in tseen]
    for k, (a, b) in enumerate(zip(tseen, jseen)):
        assert abs(a - b) <= 2e-3, (k, tseen, jseen)

    def tags(d):
        return sorted({(v["tag"], ev["step"], v["histo"] is not None)
                       for ev in jreader.list_events(d)
                       for v in ev["values"]})
    assert tags(tt) == tags(jt)
    assert ("LearningRate", 6, False) in tags(tt)
    assert ("Throughput", 1, False) in tags(tt)
    assert any(h for _, s, h in tags(tt) if s == 3)
    assert tags(tv) == tags(jv)
    assert [s for s, _, _ in treader.read_scalar(tv, "Top1Accuracy")] == \
        [1, 3, 5]
