"""The port's activations, math layers, elementwise-parameter layers,
containers and ``GradientReversal`` against the JAX package.

One parametrised case per class: forward, input gradient and parameter
gradients in float32 within 1e-5, and the forward in bf16 (output dtype
and 0.05 absolute + 0.02 relative), as ``torch_port_harness.py`` states.
Random layers are held in eval mode; ``RReLU`` in training is held to
slopes inside [lower, upper] and to bit-equal repeats under one
generator.
"""

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn

import bigdl_torch.nn as tnn
from torch_port_harness import module_bf16, module_parity, x

P = dict(positive=True)

# name -> (constructor over either package's nn, inputs)
CASES = {
    # activations
    "ReLU": (lambda nn: nn.ReLU(), lambda: x((3, 5))),
    "ReLU6": (lambda nn: nn.ReLU6(), lambda: x((3, 5), scale=5.0)),
    "PReLU": (lambda nn: nn.PReLU(), lambda: x((3, 5))),
    "PReLU_planes": (lambda nn: nn.PReLU(5), lambda: x((2, 3, 5))),
    "RReLU": (lambda nn: nn.RReLU(0.1, 0.3), lambda: x((3, 5))),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.2), lambda: x((3, 5))),
    "ELU": (lambda nn: nn.ELU(0.7), lambda: x((3, 5))),
    "GELU": (lambda nn: nn.GELU(), lambda: x((3, 5))),
    "Tanh": (lambda nn: nn.Tanh(), lambda: x((3, 5))),
    "TanhShrink": (lambda nn: nn.TanhShrink(), lambda: x((3, 5))),
    "Sigmoid": (lambda nn: nn.Sigmoid(), lambda: x((3, 5))),
    "SoftMax": (lambda nn: nn.SoftMax(), lambda: x((3, 5))),
    "SoftMin": (lambda nn: nn.SoftMin(), lambda: x((3, 5))),
    "SoftPlus": (lambda nn: nn.SoftPlus(2.0), lambda: x((3, 5))),
    "SoftSign": (lambda nn: nn.SoftSign(), lambda: x((3, 5))),
    "SoftShrink": (lambda nn: nn.SoftShrink(0.5), lambda: x((3, 5))),
    "HardShrink": (lambda nn: nn.HardShrink(0.5), lambda: x((3, 5))),
    "HardTanh": (lambda nn: nn.HardTanh(-0.5, 0.8), lambda: x((3, 5))),
    "Threshold": (lambda nn: nn.Threshold(0.1, -1.0), lambda: x((3, 5))),
    "LogSoftMax": (lambda nn: nn.LogSoftMax(), lambda: x((3, 5))),
    "LogSigmoid": (lambda nn: nn.LogSigmoid(), lambda: x((3, 5))),
    # math
    "Power": (lambda nn: nn.Power(2.5, 0.5, 1.0), lambda: x((3, 5), **P)),
    "Sqrt": (lambda nn: nn.Sqrt(), lambda: x((3, 5), **P)),
    "Square": (lambda nn: nn.Square(), lambda: x((3, 5))),
    "Clamp": (lambda nn: nn.Clamp(-0.5, 0.5), lambda: x((3, 5))),
    "Max": (lambda nn: nn.Max(1), lambda: x((3, 5, 2))),
    "Min": (lambda nn: nn.Min(-1), lambda: x((3, 5))),
    "Mean": (lambda nn: nn.Mean(1), lambda: x((3, 5, 2))),
    "Mean_keep": (lambda nn: nn.Mean(0, squeeze=False), lambda: x((3, 5))),
    "Sum": (lambda nn: nn.Sum(1), lambda: x((3, 5))),
    "Sum_average": (lambda nn: nn.Sum(2, size_average=True, squeeze=False),
                    lambda: x((3, 5, 4))),
    "Exp": (lambda nn: nn.Exp(), lambda: x((3, 5))),
    "Log": (lambda nn: nn.Log(), lambda: x((3, 5), **P)),
    "Abs": (lambda nn: nn.Abs(), lambda: x((3, 5))),
    "Scale": (lambda nn: nn.Scale((5,)), lambda: x((3, 5))),
    "MM": (lambda nn: nn.MM(), lambda: [x((2, 3, 4)), x((2, 4, 5), 1)]),
    "MM_trans": (lambda nn: nn.MM(trans_a=True, trans_b=True),
                 lambda: [x((4, 3)), x((5, 4), 1)]),
    "MV": (lambda nn: nn.MV(), lambda: [x((2, 3, 4)), x((2, 4), 1)]),
    "MV_trans": (lambda nn: nn.MV(trans=True),
                 lambda: [x((2, 4, 3)), x((2, 4), 1)]),
    "Cosine": (lambda nn: nn.Cosine(4, 3), lambda: x((2, 4))),
    "Euclidean": (lambda nn: nn.Euclidean(4, 3), lambda: x((2, 4))),
    "DotProduct": (lambda nn: nn.DotProduct(),
                   lambda: [x((3, 4)), x((3, 4), 1)]),
    "PairwiseDistance": (lambda nn: nn.PairwiseDistance(2),
                         lambda: [x((3, 4)), x((3, 4), 1)]),
    "PairwiseDistance_l1": (lambda nn: nn.PairwiseDistance(1),
                            lambda: [x((3, 4)), x((3, 4), 1)]),
    "CosineDistance": (lambda nn: nn.CosineDistance(),
                       lambda: [x((3, 4)), x((3, 4), 1)]),
    # elementwise-parameter and dense layers
    "Linear": (lambda nn: nn.Linear(4, 3), lambda: x((2, 4))),
    "Bilinear": (lambda nn: nn.Bilinear(3, 4, 2),
                 lambda: [x((2, 3)), x((2, 4), 1)]),
    "Bilinear_nobias": (lambda nn: nn.Bilinear(3, 4, 2, bias_res=False),
                        lambda: [x((2, 3)), x((2, 4), 1)]),
    "CMul": (lambda nn: nn.CMul((5,)), lambda: x((3, 5))),
    "CMul_broadcast": (lambda nn: nn.CMul((1, 5)), lambda: x((3, 5))),
    "CAdd": (lambda nn: nn.CAdd((5,)), lambda: x((3, 5))),
    "Mul": (lambda nn: nn.Mul(), lambda: x((3, 5))),
    "Add": (lambda nn: nn.Add(5), lambda: x((3, 5))),
    "MulConstant": (lambda nn: nn.MulConstant(2.5), lambda: x((3, 5))),
    "AddConstant": (lambda nn: nn.AddConstant(-1.5), lambda: x((3, 5))),
    # containers
    "ParallelTable": (lambda nn: nn.ParallelTable().add(nn.Linear(4, 3))
                      .add(nn.Tanh()), lambda: [x((2, 4)), x((2, 3), 1)]),
    "MapTable": (lambda nn: nn.MapTable(nn.Linear(4, 3)),
                 lambda: [x((2, 4)), x((2, 4), 1), x((2, 4), 2)]),
    "Echo": (lambda nn: nn.Echo(), lambda: x((3, 5))),
    "Bottle": (lambda nn: nn.Bottle(nn.Linear(4, 3), 2),
               lambda: x((2, 3, 4))),
    "Bottle_seq": (lambda nn: nn.Bottle(nn.Sequential().add(nn.Linear(4, 6))
                                        .add(nn.ReLU()), 3),
                   lambda: x((2, 2, 3, 4))),
    "Sequential": (lambda nn: nn.Sequential().add(nn.Linear(4, 3))
                   .add(nn.SoftPlus()).add(nn.Linear(3, 2)),
                   lambda: x((2, 4))),
    "Concat": (lambda nn: nn.Concat(-1).add(nn.Linear(4, 3))
               .add(nn.ELU()), lambda: x((2, 4))),
    "ConcatTable": (lambda nn: nn.ConcatTable().add(nn.Linear(4, 3))
                    .add(nn.Identity()), lambda: x((2, 4))),
    # dropout family
    "GradientReversal": (lambda nn: nn.GradientReversal(0.7),
                         lambda: x((3, 5))),
    "Dropout": (lambda nn: nn.Dropout(0.4), lambda: x((3, 5))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_reference(name):
    ctor, inputs = CASES[name]
    module_parity(ctor(jnn), ctor(tnn), inputs())


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_bf16(name):
    ctor, inputs = CASES[name]
    module_bf16(ctor(jnn), ctor(tnn), inputs())


def test_gradient_reversal_flips_and_scales():
    """The input gradient is -lambda times the output's, and set_lambda
    changes it."""
    m = tnn.GradientReversal().set_lambda(2.0).build("cpu")
    t = torch.from_numpy(x((3, 4))).requires_grad_()
    y = m(t)
    assert torch.equal(y, t.detach())
    y.backward(torch.ones_like(y))
    assert torch.equal(t.grad, torch.full_like(t, -2.0))


def test_rrelu_training_slopes():
    """In training the negative inputs' slopes lie in [lower, upper] and
    differ from element to element; one generator state gives the same
    output twice; eval and a missing generator give the mean slope."""
    m = tnn.RReLU(0.1, 0.3).build("cpu").train()
    xt = torch.from_numpy(x((64, 32)))
    neg = xt < 0
    with tnn.dropout_rng(torch.Generator().manual_seed(5)):
        y1 = m(xt)
    with tnn.dropout_rng(torch.Generator().manual_seed(5)):
        y2 = m(xt)
    assert torch.equal(y1, y2)
    slopes = y1[neg] / xt[neg]
    assert float(slopes.min()) >= 0.1 - 1e-6
    assert float(slopes.max()) <= 0.3 + 1e-6
    assert float(slopes.std()) > 0.03
    assert torch.equal(y1[~neg], xt[~neg])
    with tnn.dropout_rng(torch.Generator().manual_seed(6)):
        assert not torch.equal(m(xt), y1)
    mean = torch.where(xt >= 0, xt, 0.2 * xt)
    torch.testing.assert_close(m(xt), mean)
    torch.testing.assert_close(m.eval()(xt), mean)


def test_echo_prints_shape(capsys):
    m = tnn.Echo().set_name("probe").build("cpu")
    m(torch.zeros((2, 3)))
    assert "probe: shape (2, 3)" in capsys.readouterr().out


def test_map_table_shares_one_child():
    """One child, one param tree: ``[child's]``, as the reference's."""
    from bigdl_torch.utils.convert import to_reference_tree
    m = tnn.MapTable(tnn.Linear(4, 3)).build("cpu")
    params, _ = to_reference_tree(m)
    assert len(params) == 1 and sorted(params[0]) == ["bias", "weight"]
    a, b = torch.from_numpy(x((2, 4))), torch.from_numpy(x((2, 4), 1))
    ya, yb = m([a, b])
    torch.testing.assert_close(yb, m.layers[0](b))


@pytest.mark.parametrize("average", [False, True])
def test_msra_filler_matches_reference_distribution(average):
    """MsraFiller draws N(0, 2 / n), n the fan in or the fans' mean: the
    sample's mean and standard deviation agree with the JAX package's
    within 5% of the expected deviation (the bit streams differ)."""
    import jax
    shape = (256, 64, 3, 3)
    fan_in, fan_out = tnn.compute_fans(shape)
    t = tnn.MsraFiller(average)(torch.Generator().manual_seed(0), shape,
                                fan_in, fan_out).numpy()
    j = np.asarray(jnn.MsraFiller(average)(jax.random.key(0), shape,
                                           fan_in, fan_out))
    n = (fan_in + fan_out) / 2.0 if average else fan_in
    std = float(np.sqrt(2.0 / n))
    for s in (t, j):
        assert abs(float(s.mean())) < 0.05 * std
        assert abs(float(s.std()) - std) < 0.05 * std
