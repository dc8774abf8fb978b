"""The recommendation data and Wide & Deep against the JAX package.

- ``hash_bucket``, ``cross_bucket``, ``FeatureSpec``'s ids, the seeded
  ``synthetic_criteo_records`` and ``TabularToSample``'s vectors equal the
  reference's exactly (bytes of every float32 vector and int32 label), as
  do the shards ``write_criteo_shards`` writes; a record that breaks the
  schema raises ``CorruptRecord`` in both.
- ``WideDeep`` (a small spec: 512 deep rows, 256 wide rows, embeddings of
  8) from the reference's weights on featurized records with empty (-1)
  tag slots: eval-mode forward, input and parameter gradients within 1e-5;
  an empty slot's row 0 gets exactly zero gradient from it.
- Trained 5 steps through both packages' ``Optimizer`` (``SGD(0.05)``,
  batch 8): every loss within 2e-3.
"""

import os

import numpy as np
import pytest
import torch

import jax
from bigdl_tpu import Engine as JEngine
import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import recsys as jrec
from bigdl_tpu.models import widedeep as jwd
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.utils.recordio import CorruptRecord as JCorrupt

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet
from bigdl_torch.dataset import recsys as trec
from bigdl_torch.models import WideDeep
from bigdl_torch.optim import SGD, Optimizer, Trigger
from bigdl_torch.utils.recordio import CorruptRecord as TCorrupt
from torch_port_harness import build_pair, module_parity

STEPS = 5
TRAIN_TOL = 2e-3
SMALL = dict(n_cat=5, n_dense=3, multihot_slots=4, deep_buckets=512,
             wide_buckets=256)


def _specs(**kw):
    return jrec.FeatureSpec(**kw), trec.FeatureSpec(**kw)


@pytest.mark.parametrize("value", ["a", 17, "c3:v99", ""])
def test_hashes_match_reference(value):
    for buckets in (1, 7, 4096):
        assert trec.hash_bucket(value, buckets, salt="col2") == \
            jrec.hash_bucket(value, buckets, salt="col2")
        assert trec.cross_bucket((value, "z"), buckets) == \
            jrec.cross_bucket((value, "z"), buckets)


@pytest.mark.parametrize("kw", [{}, SMALL,
                                dict(SMALL, multihot_slots=0,
                                     cross_pairs=[(0, 4), (1, 2)])],
                         ids=["default", "small", "no_tags"])
def test_featurized_vectors_equal_reference(kw):
    js, ts = _specs(**kw)
    assert (ts.n_deep_slots, ts.n_wide, ts.input_dim, ts.stride) == \
        (js.n_deep_slots, js.n_wide, js.input_dim, js.stride)
    jr = list(jrec.synthetic_criteo_records(64, spec=js, seed=3))
    tr = list(trec.synthetic_criteo_records(64, spec=ts, seed=3))
    assert tr == jr
    assert not ts.multihot_slots or any(
        len(r["tags"]) < ts.multihot_slots for r in tr)
    got = list(trec.TabularToSample(ts)(iter(tr)))
    want = list(jrec.TabularToSample(js)(iter(jr)))
    for a, b in zip(got, want):
        assert a.feature.dtype == b.feature.dtype == np.float32
        assert a.feature.tobytes() == b.feature.tobytes()
        assert a.label.dtype == b.label.dtype
        assert a.label.tobytes() == b.label.tobytes()


@pytest.mark.parametrize("record", [
    {"cats": ["a"] * 8, "dense": [1.0] * 3, "label": 1},
    {"cats": ["a"] * 8, "label": 0},
    {"cats": ["a"] * 8, "dense": [1.0] * 4, "label": "x"},
], ids=["arity", "missing", "label"])
def test_bad_records_raise_like_reference(record):
    js, ts = _specs()
    with pytest.raises(JCorrupt):
        js.featurize(record)
    with pytest.raises(TCorrupt):
        ts.featurize(record)


def test_shards_byte_equal(tmp_path):
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    jp = jrec.write_criteo_shards(str(tmp_path / "j" / "c"), 50, shards=3,
                                  seed=2)
    tp = trec.write_criteo_shards(str(tmp_path / "t" / "c"), 50, shards=3,
                                  seed=2)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    assert [open(p, "rb").read() for p in tp] == \
        [open(p, "rb").read() for p in jp]
    # read back through the port's stream into the same vectors
    ts = trec.FeatureSpec()
    got = list(DataSet.record_stream(tp).transform(
        trec.TabularToSample(ts)).data(train=False))
    assert len(got) == 50


def _features(n, seed=5):
    js, ts = _specs(**SMALL)
    recs = list(trec.synthetic_criteo_records(n, spec=ts, seed=seed))
    samples = list(trec.TabularToSample(ts)(iter(recs)))
    return ts, js, samples


def _models(ts, js, **kw):
    return (jwd.WideDeep.from_spec(js, embed_dim=8, hidden=(16, 8), **kw),
            WideDeep.from_spec(ts, embed_dim=8, hidden=(16, 8), **kw))


def test_widedeep_matches_reference():
    ts, js, samples = _features(6)
    feats = np.stack([s.feature for s in samples])
    # at least one empty tag slot and one full one
    tags = feats[:, ts.n_cat:ts.n_deep_slots]
    assert (tags < 0).any() and (tags >= 0).any()
    jm, tm = _models(ts, js)
    assert tm.input_dim == jm.input_dim == feats.shape[1]
    module_parity(jm, tm, feats)


def test_empty_slots_get_no_gradient():
    """Every deep id moved off row 0, so row 0 is read only by the
    empty (-1) slots: its gradient is exactly zero, as the reference's."""
    ts, js, samples = _features(6)
    feats = np.stack([s.feature for s in samples])
    ids = feats[:, :ts.n_deep_slots]
    ids[ids == 0] = 1.0
    jm, tm = build_pair(*_models(ts, js))
    xt = torch.from_numpy(feats)
    tm.eval()(xt).sum().backward()
    g = tm.layers[0].weight.grad
    assert torch.count_nonzero(g[0]) == 0
    assert torch.count_nonzero(g[1:]) > 0

    def loss(p):
        y, _ = jm.apply(p, jm.state, jax.numpy.asarray(feats))
        return y.sum()
    jg = jax.grad(loss)(jm.params)
    assert not np.asarray(jg[0]["weight"])[0].any()
    np.testing.assert_allclose(g.numpy(), np.asarray(jg[0]["weight"]),
                               atol=1e-5)


def _recorder(trigger_cls, losses):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    return trigger_cls(fn, "record")


def test_widedeep_trains_like_reference():
    ts, js, samples = _features(8 * STEPS, seed=7)
    jm, tm = build_pair(*_models(ts, js))
    recs = list(trec.synthetic_criteo_records(8 * STEPS, spec=ts, seed=7))
    jlosses, tlosses = {}, {}
    JEngine.init(devices=jax.devices()[:2])
    try:
        jds = JDataSet.array(recs).transform(jrec.TabularToSample(js))
        JOptimizer(jm, jds, jnn.ClassNLLCriterion(), batch_size=8) \
            .set_optim_method(JSGD(0.05)) \
            .set_end_when(_recorder(JTrigger, jlosses)).optimize()
    finally:
        JEngine.reset()
    tds = DataSet.array(recs).transform(trec.TabularToSample(ts))
    Optimizer(tm, tds, tnn.ClassNLLCriterion(), batch_size=8,
              device="cpu") \
        .set_optim_method(SGD(0.05)) \
        .set_end_when(_recorder(Trigger, tlosses)).optimize()
    assert sorted(tlosses) == sorted(jlosses) == list(range(1, STEPS + 1))
    for k in jlosses:
        assert abs(tlosses[k] - jlosses[k]) <= TRAIN_TOL, (k, tlosses,
                                                           jlosses)
    assert tlosses[STEPS] != tlosses[1]
