"""The gradient wire: the port's Optimizer rounds every gradient through
``DTypePolicy.wire_dtype`` before the update, as the JAX package's train
step does (``bigdl_tpu/optim/optimizer.py`` ``_build_step``).

One ``SGD(1.0)`` step of a ``Linear(37, 5)`` at batch 16 from the same
weights in both packages.  Without the wire the port's update differs
from the JAX package's by about 7e-4 (the size of a bf16 rounding of the
gradient); with it, the two updates agree to 1e-7: both sides round the
same float32 gradient to bf16 and differ only where float32 summation
order moves a gradient across a bf16 rounding boundary, which this seeded
input does not.
"""

import numpy as np
import pytest
import torch

import jax
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch.common import DTypePolicy, get_policy, set_policy
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.parallel import wire_cast
from bigdl_torch.utils.convert import load_reference_tree

WIRE_TOL = 1e-7


def _one_sgd_step(policy):
    rs = np.random.RandomState(0)
    x = rs.standard_normal((16, 37)).astype(np.float32)
    y = rs.randint(0, 5, 16).astype(np.int32)
    jm = jnn.Linear(37, 5)
    jm.build(jax.random.key(3))
    tm = tnn.Linear(37, 5).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params))

    JEngine.init()
    JOptimizer(jm, JDataSet.array([JSample.from_ndarray(x[i], y[i])
                                   for i in range(16)]),
               jnn.CrossEntropyCriterion(), batch_size=16) \
        .set_optim_method(JSGD(1.0)) \
        .set_end_when(JTrigger.max_iteration(1)).optimize()
    saved = get_policy()
    set_policy(policy)
    try:
        TOptimizer(tm, TDataSet.array([TSample.from_ndarray(x[i], y[i])
                                       for i in range(16)]),
                   tnn.CrossEntropyCriterion(), batch_size=16,
                   device="cpu") \
            .set_optim_method(TSGD(1.0)) \
            .set_end_when(TTrigger.max_iteration(1)).optimize()
    finally:
        set_policy(saved)
    return max(float(np.abs(tm.weight.detach().numpy()
                            - np.asarray(jm.params["weight"])).max()),
               float(np.abs(tm.bias.detach().numpy()
                            - np.asarray(jm.params["bias"])).max()))


def test_policy_wire_defaults_to_bf16():
    policy = DTypePolicy()
    assert policy.wire_dtype == torch.bfloat16
    assert "wire=torch.bfloat16" in repr(policy)


def test_one_step_matches_reference_through_the_wire():
    """The port's update equals the JAX package's within 1e-7."""
    assert _one_sgd_step(DTypePolicy()) <= WIRE_TOL


def test_without_the_wire_the_update_differs():
    """The same step with no wire misses the reference by a bf16 rounding
    of the gradient: the check above has teeth."""
    assert _one_sgd_step(DTypePolicy(wire_dtype=None)) > 1e-5


@pytest.mark.parametrize("wire", [torch.bfloat16, None])
def test_wire_cast_rounds_each_gradient(wire):
    g = [torch.tensor([1.0 + 2.0 ** -10, -3.0]), torch.tensor([[0.1]])]
    out = wire_cast(g, wire)
    if wire is None:
        assert out is g
        return
    assert [t.dtype for t in out] == [torch.float32] * 2
    assert out[0].tolist() == [1.0, -3.0]
    assert out[1].item() == torch.tensor(0.1).to(torch.bfloat16).item()
