"""Sharded bulk inference against the JAX package: ``Evaluator`` and
``Predictor`` under the Engine's group spread each batch over the ranks
(the reference's ``_ShardedForward``, ``tests/test_eval_sharded.py``):
the batch padded to a multiple of the world, each rank forwarding its own
block, ``Predictor`` gathering the rows back into order and ``Evaluator``
summing every rank's results.

Two gloo ranks run in subprocesses (``test_torch_port_dp._spawn_ranks``)
over 13 rows at batch 5, so neither the rows nor a batch divide by the
world, and one rank's share of the last batch holds no valid row; and
over one row, where one rank's share of every batch holds none.

Tolerances: accuracy counts exact; float32 outputs and losses within 1e-5
of one process's and of the JAX package's sharded ``Evaluator`` and
``Predictor`` on the 8-device mesh (summation order only); the two ranks
bit-equal.
"""

import numpy as np
import pytest
import torch

import jax

import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.optim import Evaluator as JEvaluator
from bigdl_tpu.optim import Predictor as JPredictor
from bigdl_tpu.optim import validation as jval

import bigdl_torch.nn as tnn
from bigdl_torch import Engine
from bigdl_torch.dataset import Sample
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.optim import Evaluator, Predictor
from bigdl_torch.optim import validation as tval
from bigdl_torch.parallel import DataParallel
from bigdl_torch.utils.convert import load_reference_tree

from test_torch_port_dp import _data, _small_resnet, _spawn_ranks

OUT_TOL = 1e-5
ROWS = 13
BATCH = 5

_WORKER = '''
import pickle, sys
import torch
from bigdl_torch import Engine
import bigdl_torch.nn as nn
from bigdl_torch.dataset import Sample
from bigdl_torch.models import resnet as mod
from bigdl_torch.optim import Evaluator, Predictor
from bigdl_torch.optim import validation as v
from bigdl_torch.utils.convert import load_reference_tree

job = pickle.load(open(sys.argv[1], "rb"))
torch.set_num_threads(1)
Engine.init(device="cpu")
model = _small_resnet(mod, nn, True).build("cpu")
load_reference_tree(model, job["params"], job["state"])
samples = [Sample.from_ndarray(a, b) for a, b in zip(job["x"], job["y"])]
methods = [v.Top1Accuracy(), v.Loss(nn.CrossEntropyCriterion())]
results = Evaluator(model).test(samples, methods, job["batch"])
lone = Evaluator(model).test(samples[:1], methods, job["batch"])
pred = Predictor(model, job["batch"])
out = {"rank": Engine.rank(),
       "evaluate": [(m.name, vars(r)) for m, r in results],
       "evaluate_one_row": [(m.name, vars(r)) for m, r in lone],
       "predict": pred.predict(samples), "predict_array": pred.predict(job["x"]),
       "collectives": Engine.collectives()}
pickle.dump(out, open(job["out"] + "." + str(Engine.rank()), "wb"))
Engine.reset()
'''


@pytest.fixture(autouse=True)
def _port_engine():
    Engine.reset()
    yield
    Engine.reset()


def _pair():
    jm = _small_resnet(jresnet, jnn, True)
    jm.build(jax.random.key(3))
    tm = _small_resnet(tresnet, tnn, True).build("cpu")
    params, state = jax.tree.map(np.asarray, (jm.params, jm.state))
    load_reference_tree(tm, params, state)
    return jm, tm, params, state


def _methods(v, nn):
    return [v.Top1Accuracy(), v.Loss(nn.CrossEntropyCriterion())]


def _same_results(got, want):
    for (name, fields), (wm, wr) in zip(got, want):
        assert name == wm.name
        wf = vars(wr)
        assert fields["count"] == wf["count"]
        for k, val in wf.items():
            if k == "correct":
                assert fields[k] == val
            elif k != "count":
                assert abs(fields[k] - val) <= OUT_TOL * max(1, abs(val))


def test_two_ranks_evaluate_and_predict_like_one_process(tmp_path):
    jm, tm, params, state = _pair()
    x, y = _data(ROWS, seed=4)
    wait = _spawn_ranks(dict(params=params, state=state, x=x, y=y,
                             batch=BATCH), tmp_path, worker=_WORKER)
    samples = [Sample.from_ndarray(x[i], y[i]) for i in range(ROWS)]
    one = Evaluator(tm, device="cpu").test(samples, _methods(tval, tnn),
                                           BATCH)
    one_row = Evaluator(tm, device="cpu").test(samples[:1],
                                               _methods(tval, tnn), BATCH)
    one_pred = Predictor(tm, BATCH, device="cpu").predict(samples)
    JEngine.init()
    jsamples = [JSample.from_ndarray(x[i], y[i]) for i in range(ROWS)]
    want = JEvaluator(jm).test(JDataSet.array(jsamples),
                               _methods(jval, jnn), BATCH)
    jpred = np.asarray(JPredictor(jm, batch_size=BATCH).predict(
        JDataSet.array(jsamples)))
    r0, r1 = wait()
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for key in ("predict", "predict_array"):
        assert np.array_equal(r0[key], r1[key])
        assert r0[key].shape == one_pred.shape == jpred.shape == (ROWS, 10)
        for ref in (one_pred, jpred):
            np.testing.assert_allclose(r0[key], ref, atol=OUT_TOL,
                                       rtol=OUT_TOL)
    assert r0["evaluate"] == r1["evaluate"]
    for ref in (one, want):
        _same_results(r0["evaluate"], ref)
    assert r0["evaluate"][0][1]["count"] == ROWS
    # rank 1 holds no valid row at all: its zeroed results add nothing
    assert r0["evaluate_one_row"] == r1["evaluate_one_row"]
    _same_results(r0["evaluate_one_row"], one_row)
    assert r0["evaluate_one_row"][0][1]["count"] == 1
    # one all-reduce of the results per test call; one gather of each
    # batch's rows per predict call
    n_batches = -(-ROWS // BATCH)
    assert r0["collectives"]["all_reduce"] == {"validation": 2}
    assert r0["collectives"]["all_gather"] == {"predict": 2 * n_batches}


def test_world_of_one_and_misuse():
    """A world of one answers as one device, bit for bit; a strategy
    without a group, or a device other than the Engine's, raises."""
    _, tm, _, _ = _pair()
    x, y = _data(ROWS, seed=4)
    samples = [Sample.from_ndarray(x[i], y[i]) for i in range(ROWS)]
    one = Predictor(tm, BATCH, device="cpu").predict(samples)
    with pytest.raises(RuntimeError, match="Engine.init"):
        Evaluator(tm, DataParallel(), device="cpu")
    Engine.init(device="cpu")
    with pytest.raises(ValueError, match="Engine's rank"):
        Predictor(tm, BATCH, device="meta")
    grouped = Predictor(tm, BATCH).predict(samples)
    assert np.array_equal(grouped, one)
    res = Evaluator(tm).test(samples, _methods(tval, tnn), BATCH)
    assert res[0][1].count == ROWS
    assert Engine.all_gathers == {}
