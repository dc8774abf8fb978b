"""Checkpoint files of the port against the JAX package's.

- CRC32C: the port's compiled route (``csrc/host/crc32c.cc``) and its
  Python table loop equal the reference's ``crc32c_update`` on random and
  empty buffers, whole and in chunks.
- A blob written by either package's ``file_io.save`` loads in the other,
  numpy leaves bit for bit.
- A truncated, bit-flipped or unpicklable file raises ``CorruptCheckpoint``
  from ``load`` and ``verify`` in both packages; the lineage helpers list,
  quarantine and prune as the reference's (``resume_from``'s fall-back is
  in ``test_torch_port_resume.py``).
- The optimizer state's carry-over (``utils/convert.py``): the port's
  per-parameter lists follow ``model.parameters()``, the reference's trees
  sort a leaf's dict by name; ``to_reference_opt_state`` of the parameters
  themselves must be the model's own reference tree, leaf for leaf, on
  ResNet, the TransformerLM and LeNet-5, and come back through
  ``load_reference_opt_state``; mismatches raise.
- ``Optimizer.set_checkpoint``: the files of a run, the driver state and
  method state inside them, ``keep_last`` / ``keep_every_epochs`` against
  the reference's retention on the same run, and the parts that are not
  ported raising.
"""

import os

import numpy as np
import pytest
import torch

import jax
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.utils import file_io as jio
from bigdl_tpu.utils.recordio import crc32c_update as jcrc

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import lenet as tlenet
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Adam as TAdam
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.utils import crc32c as tcrc
from bigdl_torch.utils import file_io as tio
from bigdl_torch.utils.convert import (load_reference_opt_state,
                                       load_reference_tree,
                                       to_reference_opt_state,
                                       to_reference_tree)


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


# -- CRC32C and the frame -----------------------------------------------------

BUFFERS = {"empty": b"", "one": b"\x5a", "seven": bytes(range(7)),
           "random_4k": np.random.RandomState(0).bytes(4099),
           "random_1m": np.random.RandomState(1).bytes(1 << 20)}


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_crc32c_like_reference(name):
    data = BUFFERS[name]
    want = jcrc(0, data)
    assert tcrc.route().startswith("compiled")
    assert tcrc.crc32c_update(0, data) == want
    if len(data) < 5000:          # the table loop runs at a few MB/s
        assert tcrc.crc32c_table(0, data) == want
    # continued over chunks, as the frame's tee feeds it
    crc = 0
    for i in range(0, len(data), 1000):
        crc = tcrc.crc32c_update(crc, data[i:i + 1000])
    assert crc == want


def test_crc32c_known_value():
    # the Castagnoli check value of "123456789"
    assert tcrc.crc32c_update(0, b"123456789") == 0xE3069283
    assert tcrc.crc32c_table(0, b"123456789") == 0xE3069283


def _blob(seed):
    rs = np.random.RandomState(seed)
    return {"params": [{"weight": rs.standard_normal((3, 4)).astype(
        np.float32), "bias": np.zeros(3, np.float32)}, {}],
        "state": [{}, {"running_mean": rs.rand(3).astype(np.float32)}],
        "t": np.int32(7), "driver": {"epoch": 2, "loss": 0.5}}


def _same(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_blobs_load_in_both_directions(tmp_path):
    blob = _blob(0)
    tio.save(blob, str(tmp_path / "port"))
    jio.save(blob, str(tmp_path / "ref"))
    # the same frame (the reference's pickle sorts dict keys, by its tree
    # map, so the payloads need not be byte-equal)
    for name in ("port", "ref"):
        assert (tmp_path / name).read_bytes()[-8:] == b"BGLNCKP1"
    _same(jio.load(str(tmp_path / "port")), blob)
    _same(tio.load(str(tmp_path / "ref")), blob)
    tio.verify(str(tmp_path / "ref"))
    jio.verify(str(tmp_path / "port"))
    # torch tensors become numpy
    tio.save({"w": torch.arange(4.0)}, str(tmp_path / "tensor"))
    got = jio.load(str(tmp_path / "tensor"))["w"]
    assert isinstance(got, np.ndarray) and got.tolist() == [0, 1, 2, 3]
    with pytest.raises(FileExistsError):
        tio.save(blob, str(tmp_path / "port"), overwrite=False)
    assert not list(tmp_path.glob("*.tmp"))


CORRUPTIONS = {
    "truncated": lambda b: b[:len(b) // 2] + b[-20:],
    "bit_flip": lambda b: b[:40] + bytes([b[40] ^ 0x10]) + b[41:],
    "unpicklable": lambda b: jio.frame_bytes(b"not a pickle"),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corrupt_file_raises(name, tmp_path):
    path = str(tmp_path / "model.1")
    tio.save(_blob(1), path)
    data = open(path, "rb").read()
    open(path, "wb").write(CORRUPTIONS[name](data))
    with pytest.raises(tio.CorruptCheckpoint):
        tio.load(path)
    with pytest.raises(jio.CorruptCheckpoint):
        jio.load(path)
    if name != "unpicklable":
        with pytest.raises(tio.CorruptCheckpoint):
            tio.verify(path)


def test_lineage_quarantine_and_prune(tmp_path):
    d = str(tmp_path)
    for n in (2, 4, 6, 8):
        tio.save_checkpoint(d, n, {"n": n}, {"n": n})
    open(os.path.join(d, "model.9"), "wb").write(b"half a pair")
    assert [n for _, _, n in tio.checkpoint_lineage(d)] == [8, 6, 4, 2]
    assert tio.checkpoint_lineage(d) == jio.checkpoint_lineage(d)
    assert tio.latest_checkpoint(d)[2] == 8
    tio.quarantine_checkpoint(os.path.join(d, "model.8"),
                              os.path.join(d, "optimMethod.8"))
    assert os.path.exists(os.path.join(d, "model.8.corrupt"))
    assert tio.latest_checkpoint(d)[2] == 6
    assert tio.prune_checkpoints(d, 1, keep={2}) == [4]
    assert [n for _, _, n in tio.checkpoint_lineage(d)] == [6, 2]
    assert os.path.exists(os.path.join(d, "optimMethod.8.corrupt"))
    assert tio.prune_checkpoints(d, 0) == []


def test_unported_checkpoint_options_raise(tmp_path):
    opt = TOptimizer(tnn.Linear(2, 2), TDataSet.array(
        [TSample(np.zeros(2, np.float32), np.int32(0))]),
        tnn.ClassNLLCriterion(), device="cpu")
    trig = TTrigger.every_epoch()
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 5"):
        opt.set_checkpoint(str(tmp_path), trig, publish=True)
    # asynchronous writes and schemes are ported: setting them raises
    # nothing, and a scheme no filesystem serves raises when it is used
    opt.set_checkpoint(str(tmp_path), trig, async_write=True)
    with pytest.raises(ValueError, match="nosuchscheme"):
        tio.save({}, "nosuchscheme://bucket/x")


# -- the optimizer state's tree, leaf by leaf -----------------------------------

def _small_resnet(mod, nn):
    m = nn.Sequential()
    m.add(mod._conv(3, 8, 3, 3, 2, 2, 1, 1))
    m.add(nn.SpatialBatchNormalization(8)).add(nn.ReLU())
    b1, ch = mod._bottleneck(8, 4, 2, "B")
    m.add(nn.Sequential().add(b1))
    m.add(nn.Reshape((ch * 16,))).add(nn.Linear(ch * 16, 10))
    return m


LM_CFG = dict(vocab_size=53, max_len=12, d_model=32, num_heads=4,
              num_layers=2)


class _Shapes:
    """A reference model's (params, state) as shape structs, traced
    without drawing weights."""

    def __init__(self, model):
        self.params, self.state = jax.eval_shape(model.init,
                                                 jax.random.key(0))

PAIRS = {
    "resnet": (lambda: _small_resnet(tresnet, tnn),
               lambda: _small_resnet(jresnet, jnn).build(jax.random.key(0))),
    # shapes only: initializing ResNet-50's weights in JAX takes seconds
    "resnet50": (lambda: tresnet.ResNet(50, class_num=1000,
                                        dataset="imagenet"),
                 lambda: _Shapes(jresnet.ResNet(50, class_num=1000,
                                                dataset="imagenet"))),
    "lm": (lambda: tlm.TransformerLM(**LM_CFG),
           lambda: jlm.TransformerLM(**LM_CFG).build(jax.random.key(0))),
    "lenet": (lambda: tlenet.LeNet5(10),
              lambda: jlenet.LeNet5(10).build(jax.random.key(0))),
}


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_opt_state_follows_the_reference_tree(kind):
    tm = PAIRS[kind][0]().build("cpu")
    jm = PAIRS[kind][1]()
    if kind != "resnet50":
        load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                            jax.tree.map(np.asarray, jm.state))
    params = list(tm.parameters())
    method = TSGD(0.1, momentum=0.9)
    tree = to_reference_opt_state(tm, method, {"velocity": params})
    ref = to_reference_tree(tm)[0]
    assert jax.tree.structure(tree["velocity"]) == \
        jax.tree.structure(jm.params)
    for a, b, c in zip(jax.tree.leaves(tree["velocity"]),
                       jax.tree.leaves(ref), jax.tree.leaves(jm.params)):
        assert a.shape == b.shape == c.shape and np.array_equal(a, b)
    if kind != "resnet50":
        for a, b in zip(jax.tree.leaves(tree["velocity"]),
                        jax.tree.leaves(jm.params)):
            assert np.array_equal(a, np.asarray(b))
    back = load_reference_opt_state(tm, method, tree)
    assert all(torch.equal(a, b) for a, b in zip(back["velocity"], params))
    # Adam: two slots and the int32 count
    adam = TAdam()
    st = {"m": [p * 2 for p in params], "v": [p * 3 for p in params],
          "t": np.int32(4)}
    tree = to_reference_opt_state(tm, adam, st)
    assert tree["t"].dtype == np.int32 and tree["t"].shape == ()
    back = load_reference_opt_state(tm, adam, tree)
    assert back["t"] == 4
    for key in ("m", "v"):
        assert all(torch.equal(a, b) for a, b in zip(back[key], st[key]))


def test_opt_state_mismatches_raise():
    tm = PAIRS["lenet"][0]().build("cpu")
    params = list(tm.parameters())
    method = TSGD(0.1, momentum=0.9)
    tree = to_reference_opt_state(tm, method, {"velocity": params})
    with pytest.raises(ValueError, match="slots"):
        load_reference_opt_state(tm, TAdam(), tree)
    with pytest.raises(ValueError, match="slots"):
        to_reference_opt_state(tm, method, {"m": params})
    with pytest.raises(ValueError, match="tensors for"):
        to_reference_opt_state(tm, method, {"velocity": params[:-1]})
    bad = jax.tree.map(lambda a: a, tree)
    bad["velocity"][1]["weight"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_reference_opt_state(tm, method, bad)
    bad = {"velocity": tree["velocity"][:-1]}
    with pytest.raises(ValueError, match="list of"):
        load_reference_opt_state(tm, method, bad)


# -- a run's files ------------------------------------------------------------

def _lenet_samples(Sample, n=48, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, 28, 28)).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int32)
    return [Sample.from_ndarray(x[i], y[i]) for i in range(n)]


def _run_port(path, epochs, **kw):
    m = tlenet.LeNet5(10).build("cpu", torch.Generator().manual_seed(0))
    opt = TOptimizer(m, TDataSet.array(_lenet_samples(TSample)),
                     tnn.ClassNLLCriterion(), batch_size=8, device="cpu")
    opt.set_optim_method(TSGD(0.05, momentum=0.9))
    opt.set_checkpoint(path, TTrigger.several_iteration(4), **kw)
    opt.set_end_when(TTrigger.max_epoch(epochs)).optimize()
    return m, opt


def _run_reference(path, epochs, **kw):
    m = jlenet.LeNet5(10)
    opt = JOptimizer(m, JDataSet.array(_lenet_samples(JSample)),
                     jnn.ClassNLLCriterion(), batch_size=8)
    opt.set_optim_method(JSGD(0.05, momentum=0.9))
    opt.set_checkpoint(path, JTrigger.several_iteration(4), **kw)
    opt.set_end_when(JTrigger.max_epoch(epochs)).optimize()
    return m, opt


def test_run_files_and_retention_like_reference(tmp_path):
    JEngine.init()
    kw = dict(keep_last=2, keep_every_epochs=2)
    m, opt = _run_port(str(tmp_path / "port"), 4, **kw)
    _run_reference(str(tmp_path / "ref"), 4, **kw)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref"))
    assert not any(n.endswith(".tmp") for n in names)
    mp, op, n = tio.latest_checkpoint(str(tmp_path / "port"))
    # 6 iterations an epoch, a snapshot at every 4th (the driver's neval
    # is 4 after iteration 3): the last after iteration 23, in epoch 4
    assert n == 23
    blob, oblob = jio.load(mp), jio.load(op)
    # the run's last iteration came after the snapshot
    params, state = to_reference_tree(m)
    assert jax.tree.structure(blob["params"]) == jax.tree.structure(params)
    assert jax.tree.structure(blob["state"]) == jax.tree.structure(state)
    assert not np.array_equal(jax.tree.leaves(blob["params"])[0],
                              jax.tree.leaves(params)[0])
    assert oblob["driver_state"]["neval"] == 24
    assert oblob["driver_state"]["epoch"] == 4
    assert oblob["rng_state"] is None
    assert oblob["method"]["learning_rate"] == 0.05
    assert oblob["torch_rng_state"]["device"] == "cpu"
    assert jax.tree.structure(oblob["opt_state"]["velocity"]) == \
        jax.tree.structure(jax.tree.map(np.asarray,
                                        jlenet.LeNet5(10).build(
                                            jax.random.key(0)).params))
