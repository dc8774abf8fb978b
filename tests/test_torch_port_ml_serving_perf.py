"""The ML estimators, the UDF serving adapters, the bulk batcher and the
throughput CLI against the JAX package.

- ``DLClassifier`` (a small MLP from the reference's weights, ``SGD(0.1)``,
  batch 8, 2 epochs over 44 rows: the last batch of each epoch padded)
  fits like the reference: raw outputs within 2e-3 (the training-parity
  bound), the same classes and score; a DataFrame-like object (duck
  typed: ``columns``, ``[name]``, ``copy``) in, a copy with the
  prediction column out; ``DLEstimator`` with ``feature_size`` and
  ``label_size`` on a regression.
- ``UDFPredictor`` over the same weights: raw outputs within 1e-5 through
  padded batches of 5, classes equal, the empty answers of the
  reference; ``TextClassifierUDF`` classes equal on text.
- ``predict_in_fixed_batches`` gives the reference's rows exactly (zero
  rows included).
- ``tools/perf.py --device cpu`` on LeNet prints one JSON line with a
  positive rate and finite losses; ``--num-experts`` on a dense model
  raises as the reference's does.
"""

import json

import numpy as np
import pytest

import bigdl_tpu.nn as jnn
from bigdl_tpu import ml as jml
from bigdl_tpu import serving as jserving
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.serve import batcher as jbatcher

import bigdl_torch.nn as tnn
from bigdl_torch import ml as tml
from bigdl_torch import serving as tserving
from bigdl_torch.dataset import text as ttext
from bigdl_torch.optim import SGD
from bigdl_torch.serve import batcher as tbatcher
from bigdl_torch.tools import perf as tperf
from torch_port_harness import build_pair, close

FIT_TOL = 2e-3


class Frame:
    """The DataFrame surface the adapters read: named numpy columns."""

    def __init__(self, cols):
        self._c = dict(cols)

    @property
    def columns(self):
        return list(self._c)

    def __getitem__(self, k):
        return self._c[k]

    def __setitem__(self, k, v):
        self._c[k] = np.asarray(v)

    def copy(self):
        return Frame(self._c)


def _toy(n=44, d=5, classes=3, seed=0):
    rs = np.random.default_rng(seed)
    y = np.arange(n) % classes
    X = rs.standard_normal((n, d)) * 0.5
    X[np.arange(n), y] += 2.0
    return X.astype(np.float32), y.astype(np.float32)


def _mlp(mod, d=5):
    return (mod.Sequential().add(mod.Linear(d, 8)).add(mod.ReLU())
            .add(mod.Linear(8, 3)).add(mod.LogSoftMax()))


def test_dl_classifier_fits_like_reference():
    X, y = _toy()
    jm, tm = build_pair(_mlp(jnn), _mlp(tnn))
    jfit = jml.DLClassifier(jm, jnn.ClassNLLCriterion(), batch_size=8,
                            max_epoch=2, optim_method=JSGD(0.1)).fit(X, y)
    tfit = tml.DLClassifier(tm, tnn.ClassNLLCriterion(), batch_size=8,
                            max_epoch=2, optim_method=SGD(0.1),
                            device="cpu").fit(X, y)
    assert isinstance(tfit, tml.DLClassifierModel)
    traw, jraw = tfit.transform(X), jfit.transform(X)
    close(traw, jraw, tol=FIT_TOL, what="fitted outputs")
    assert np.array_equal(tfit.predict(X), jfit.predict(X))
    assert tfit.score(X, y) == jfit.score(X, y) > 0.8
    # a DataFrame-like object: labels from its label column, a copy back
    cols = {f"f{i}": X[:, i] for i in range(X.shape[1])}
    df = Frame({**cols, "label": y})
    out = tfit.transform(df)
    assert "prediction" in out.columns and "prediction" not in df.columns
    assert np.array_equal(out["prediction"], tfit.predict(X))
    assert tfit.score(df) == tfit.score(X, y)


def test_dl_estimator_shapes_like_reference():
    rs = np.random.default_rng(1)
    X = rs.standard_normal((32, 8)).astype(np.float32)
    y = (X[:, :2] @ np.array([[1.0], [-2.0]], np.float32))

    def model(mod):
        return mod.Sequential().add(mod.Reshape((8,))).add(mod.Linear(8, 1))
    jm, tm = build_pair(model(jnn), model(tnn))
    kw = dict(feature_size=(2, 4), label_size=(1,), batch_size=8,
              max_epoch=3)
    jfit = jml.DLEstimator(jm, jnn.MSECriterion(), optim_method=JSGD(0.05),
                           **kw).fit(X, y)
    tfit = tml.DLEstimator(tm, tnn.MSECriterion(), optim_method=SGD(0.05),
                           device="cpu", **kw).fit(X, y)
    assert type(tfit) is tml.DLModel
    close(tfit.predict(X), jfit.predict(X), tol=FIT_TOL, what="regression")
    with pytest.raises(ValueError, match="no labels"):
        tml.DLEstimator(tm, tnn.MSECriterion(), device="cpu").fit(X)


def test_udf_predictor_like_reference():
    jm, tm = build_pair(_mlp(jnn, 4), _mlp(tnn, 4))
    X = np.random.default_rng(2).standard_normal((13, 4)).astype(np.float32)
    traw = tserving.UDFPredictor(tm, postprocess=lambda o: o, batch_size=5,
                                 device="cpu")
    jraw = jserving.UDFPredictor(jm, postprocess=lambda o: o, batch_size=5)
    close(traw(X), jraw(X), what="udf outputs")
    tudf = tserving.UDFPredictor(tm, batch_size=5, device="cpu")
    jcls = jserving.UDFPredictor(jm, batch_size=5)(X)
    assert np.array_equal(tudf(X), jcls)
    ns = {}
    assert tudf.register(ns, "cls") is tudf and ns["cls"] is tudf
    # rows through a preprocess, one at a time
    pre = tserving.UDFPredictor(tm, preprocess=lambda r: np.asarray(r) * 2,
                                device="cpu")
    assert np.array_equal(pre(list(X / 2)), jcls)
    # the empty answers
    out = tserving.UDFPredictor(tm, device="cpu")([])
    assert out.shape == (0,) and out.dtype.kind == "i"
    col = tserving.UDFPredictor(tm, postprocess=lambda o: o[:, 1],
                                device="cpu")
    assert col([]).shape == (0,)
    assert col(X).shape == (13,)
    assert col([]).dtype.kind == "f"


def test_text_classifier_udf_like_reference():
    texts = ["the cat sat on the mat", "dogs run fast", "a cat ran",
             "unknown words only", ""]
    toks = [t.split() for t in texts]
    seq, emb_dim = 6, 4

    def model(mod):
        return (mod.Sequential().add(mod.Reshape((seq * emb_dim,)))
                .add(mod.Linear(seq * emb_dim, 3)).add(mod.LogSoftMax()))
    jm, tm = build_pair(model(jnn), model(tnn))
    td, jd = ttext.Dictionary(toks, 5), jtext.Dictionary(toks, 5)
    emb = np.random.default_rng(3).standard_normal(
        (td.vocab_size() + 1, emb_dim)).astype(np.float32)
    tudf = tserving.TextClassifierUDF(tm, td, emb, seq_len=seq,
                                      batch_size=2, device="cpu")
    judf = jserving.TextClassifierUDF(jm, jd, emb, seq_len=seq,
                                      batch_size=2)
    assert np.array_equal(tudf.embed(texts[0]), judf.embed(texts[0]))
    assert np.array_equal(tudf(texts), judf(texts))


@pytest.mark.parametrize("n,batch", [(0, 4), (3, 4), (8, 4), (11, 3)])
def test_predict_in_fixed_batches_like_reference(n, batch):
    feats = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    calls = []

    def forward(b):
        calls.append(len(b))
        return b * 2 + b.sum(axis=1, keepdims=True)
    got = tbatcher.predict_in_fixed_batches(forward, feats, batch)
    assert all(c == batch for c in calls)
    want = jbatcher.predict_in_fixed_batches(forward, feats, batch)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_perf_cli_on_the_host(capsys):
    tperf.main(["--model", "lenet", "--batch-size", "4", "--iters", "2",
                "--warmup", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "lenet" and out["batch_size"] == 4
    assert out["records_per_second"] > 0 and out["device"] == "cpu"
    assert np.isfinite(out["timing"]["first_loss"])
    assert np.isfinite(out["timing"]["last_loss"])
    assert sorted(tperf._MODELS) == sorted(
        __import__("bigdl_tpu.tools.perf", fromlist=["_MODELS"])._MODELS)
    with pytest.raises(ValueError, match="transformer only"):
        tperf.run("lenet", 4, iters=1, num_experts=2, device="cpu")
