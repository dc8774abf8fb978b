"""The port's criteria against the JAX package.

One parametrised case per criterion (and per option that changes the
arithmetic): the loss and its gradient with respect to every floating
output in float32 within 1e-5 of the larger of 1 and the reference's
magnitude, the facade's ``backward`` for tensor outputs, and the loss on
bf16 outputs (dtype and 0.05 absolute + 0.02 relative), as
``torch_port_harness.py`` states.  Labels are the reference's 0-based
ones unless a case passes ``one_based``.
"""

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn

import bigdl_torch.nn as tnn
from bigdl_torch.models.run import build_criterion
from torch_port_harness import (criterion_bf16, criterion_parity, labels,
                                signs, x)


def _probs(shape, seed):
    return (1.0 / (1.0 + np.exp(-x(shape, seed)))).astype(np.float32)


def _log_probs(shape, seed):
    v = x(shape, seed)
    return (v - np.log(np.exp(v).sum(-1, keepdims=True))).astype(np.float32)


def _binary(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) > 0.5).astype(
        np.float32)


def _multilabel(one_based):
    t = np.array([[3, 0, -1], [1, -1, -1], [4, 2, 1], [-1, -1, -1]],
                 np.int32)
    return t + 1 if one_based else t


W5 = np.linspace(0.5, 2.0, 5).astype(np.float32)

# name -> (constructor over either package's nn, output, target)
CASES = {
    "AbsCriterion": (lambda nn: nn.AbsCriterion(),
                     lambda: x((4, 5)), lambda: x((4, 5), 1)),
    "AbsCriterion_sum": (lambda nn: nn.AbsCriterion(size_average=False),
                         lambda: x((4, 5)), lambda: x((4, 5), 1)),
    "MSECriterion": (lambda nn: nn.MSECriterion(),
                     lambda: x((4, 5)), lambda: x((4, 5), 1)),
    "MSECriterion_sum": (lambda nn: nn.MSECriterion(False),
                         lambda: x((4, 5)), lambda: x((4, 5), 1)),
    "BCECriterion": (lambda nn: nn.BCECriterion(),
                     lambda: _probs((4, 5), 0), lambda: _binary((4, 5), 1)),
    "BCECriterion_weights": (lambda nn: nn.BCECriterion(W5, False),
                             lambda: _probs((4, 5), 0),
                             lambda: _binary((4, 5), 1)),
    "ClassNLLCriterion": (lambda nn: nn.ClassNLLCriterion(),
                          lambda: _log_probs((4, 5), 0),
                          lambda: labels((4,), 5, 1)),
    "CrossEntropyCriterion": (lambda nn: nn.CrossEntropyCriterion(W5),
                              lambda: x((4, 5)), lambda: labels((4,), 5, 1)),
    "ClassSimplexCriterion": (lambda nn: nn.ClassSimplexCriterion(5),
                              lambda: x((4, 5)), lambda: labels((4,), 5, 1)),
    "ClassSimplexCriterion_one_based": (
        lambda nn: nn.ClassSimplexCriterion(5, False, one_based=True),
        lambda: x((4, 5)), lambda: labels((4,), 5, 1) + 1),
    "CosineDistanceCriterion": (lambda nn: nn.CosineDistanceCriterion(),
                                lambda: x((4, 5)), lambda: x((4, 5), 1)),
    "CosineEmbeddingCriterion": (
        lambda nn: nn.CosineEmbeddingCriterion(0.1),
        lambda: [x((4, 5)), x((4, 5), 1)], lambda: signs((4,), 2)),
    "DiceCoefficientCriterion": (
        lambda nn: nn.DiceCoefficientCriterion(epsilon=0.5),
        lambda: _probs((4, 3, 2), 0), lambda: _binary((4, 3, 2), 1)),
    "DistKLDivCriterion": (lambda nn: nn.DistKLDivCriterion(),
                           lambda: _log_probs((4, 5), 0),
                           lambda: np.exp(_log_probs((4, 5), 1))),
    "DistKLDivCriterion_sum": (lambda nn: nn.DistKLDivCriterion(False),
                               lambda: _log_probs((4, 5), 0),
                               lambda: np.exp(_log_probs((4, 5), 1))),
    "HingeEmbeddingCriterion": (
        lambda nn: nn.HingeEmbeddingCriterion(0.5),
        lambda: x((4, 5)), lambda: signs((4, 5), 1)),
    "L1Cost": (lambda nn: nn.L1Cost(), lambda: x((4, 5)),
               lambda: x((4, 5), 1)),
    "L1HingeEmbeddingCriterion": (
        lambda nn: nn.L1HingeEmbeddingCriterion(4.0),
        lambda: [x((4, 5)), x((4, 5), 1)], lambda: signs((4,), 2)),
    "L1Penalty": (lambda nn: nn.L1Penalty(0.3), lambda: x((4, 5)),
                  lambda: x((4, 5), 1)),
    "L1Penalty_average": (lambda nn: nn.L1Penalty(0.3, True),
                          lambda: x((4, 5)), lambda: x((4, 5), 1)),
    "MarginCriterion": (lambda nn: nn.MarginCriterion(0.8),
                        lambda: x((4, 5)), lambda: signs((4, 5), 1)),
    "MarginCriterion_squared": (
        lambda nn: nn.MarginCriterion(1.0, squared=True),
        lambda: x((4, 5)), lambda: signs((4, 5), 1)),
    "MarginRankingCriterion": (
        lambda nn: nn.MarginRankingCriterion(0.5),
        lambda: [x((6,)), x((6,), 1)], lambda: signs((6,), 2)),
    "MultiCriterion": (lambda nn: nn.MultiCriterion()
                       .add(nn.MSECriterion(), 0.5).add(nn.AbsCriterion(), 2.0),
                       lambda: x((4, 5)), lambda: x((4, 5), 1)),
    "ParallelCriterion": (
        lambda nn: nn.ParallelCriterion().add(nn.MSECriterion())
        .add(nn.ClassNLLCriterion(), 0.5),
        lambda: [x((4, 5)), _log_probs((4, 3), 1)],
        lambda: [x((4, 5), 2), labels((4,), 3, 3)]),
    "ParallelCriterion_repeat": (
        lambda nn: nn.ParallelCriterion(True).add(nn.MSECriterion())
        .add(nn.AbsCriterion(), 0.3),
        lambda: [x((4, 5)), x((4, 5), 1)], lambda: x((4, 5), 2)),
    "MultiLabelMarginCriterion": (
        lambda nn: nn.MultiLabelMarginCriterion(),
        lambda: x((4, 5)), lambda: _multilabel(False)),
    "MultiLabelMarginCriterion_one_based": (
        lambda nn: nn.MultiLabelMarginCriterion(False, one_based=True),
        lambda: x((4, 5)), lambda: _multilabel(True)),
    "MultiLabelSoftMarginCriterion": (
        lambda nn: nn.MultiLabelSoftMarginCriterion(W5),
        lambda: x((4, 5)), lambda: _binary((4, 5), 1)),
    "MultiMarginCriterion": (lambda nn: nn.MultiMarginCriterion(),
                             lambda: x((4, 5)), lambda: labels((4,), 5, 1)),
    "MultiMarginCriterion_p2": (
        lambda nn: nn.MultiMarginCriterion(2, W5, 0.7, False, True),
        lambda: x((4, 5)), lambda: labels((4,), 5, 1) + 1),
    "SmoothL1Criterion": (lambda nn: nn.SmoothL1Criterion(),
                          lambda: x((4, 5), scale=2.0),
                          lambda: x((4, 5), 1)),
    "SmoothL1CriterionWithWeights": (
        lambda nn: nn.SmoothL1CriterionWithWeights(2.0, 3),
        lambda: x((4, 5), scale=2.0),
        lambda: [x((4, 5), 1), _binary((4, 5), 2),
                 x((4, 5), 3, positive=True)]),
    "SmoothL1CriterionWithWeights_plain": (
        lambda nn: nn.SmoothL1CriterionWithWeights(),
        lambda: x((4, 5), scale=2.0), lambda: x((4, 5), 1)),
    "SoftMarginCriterion": (lambda nn: nn.SoftMarginCriterion(),
                            lambda: x((4, 5)), lambda: signs((4, 5), 1)),
    "SoftmaxWithCriterion": (lambda nn: nn.SoftmaxWithCriterion(),
                             lambda: x((2, 3, 3, 4)),
                             lambda: labels((2, 3, 3), 4, 1)),
    "SoftmaxWithCriterion_ignore": (
        lambda nn: nn.SoftmaxWithCriterion(2, "batch_size", one_based=True),
        lambda: x((2, 3, 3, 4)), lambda: labels((2, 3, 3), 4, 1) + 1),
    "SoftmaxWithCriterion_full": (
        lambda nn: nn.SoftmaxWithCriterion(1, "full"),
        lambda: x((2, 3, 3, 4)), lambda: labels((2, 3, 3), 4, 1)),
    "SoftmaxWithCriterion_none": (
        lambda nn: nn.SoftmaxWithCriterion(None, "none"),
        lambda: x((2, 3, 3, 4)), lambda: labels((2, 3, 3), 4, 1)),
    "TimeDistributedCriterion_mse": (
        lambda nn: nn.TimeDistributedCriterion(nn.MSECriterion(), True),
        lambda: x((3, 4, 5)), lambda: x((3, 4, 5), 1)),
    "TimeDistributedCriterion_bce": (
        lambda nn: nn.TimeDistributedCriterion(nn.BCECriterion()),
        lambda: _probs((3, 4, 5), 0), lambda: _binary((3, 4, 5), 1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_criterion_matches_reference(name):
    ctor, output, target = CASES[name]
    criterion_parity(ctor(jnn), ctor(tnn), output(), target())


@pytest.mark.parametrize("name", sorted(CASES))
def test_criterion_bf16(name):
    ctor, output, target = CASES[name]
    criterion_bf16(ctor(jnn), ctor(tnn), output(), target())


def test_cli_builds_mse():
    """The zoo CLI's ``"mse"`` pairing is the port's MSECriterion."""
    assert isinstance(build_criterion("mse"), tnn.MSECriterion)


def test_time_distributed_steps_of_a_plain_criterion():
    """A criterion on tensors gives one loss a step to
    TimeDistributedCriterion: each its own ``loss`` on that step."""
    out = torch.from_numpy(x((3, 4, 5)))
    tgt = torch.from_numpy(x((3, 4, 5), 1))
    got = tnn.MSECriterion().step_losses(out, tgt)
    want = torch.stack([tnn.MSECriterion()(out[:, t], tgt[:, t])
                        for t in range(4)])
    assert torch.equal(got, want)
