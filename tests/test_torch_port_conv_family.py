"""The port's other convolutions against the JAX package:
``SpatialShareConvolution``, ``SpatialConvolutionMap``,
``SpatialDilatedConvolution``, ``SpatialFullConvolution``,
``TemporalConvolution`` and ``VolumetricConvolution``, and the
convolutional LSTM cells ``ConvLSTMPeephole`` and ``ConvLSTMPeephole3D``
under ``Recurrent``.

Each case: forward, input gradient and parameter gradients in float32
within 1e-5 of the JAX module's (the harness's rule, parameters carried
across with ``load_reference_tree``); one case per class also the forward
in bf16.
``SpatialFullConvolution`` runs with groups and with ``adj`` at 0,
stride - 1 and stride (which PyTorch's transposed convolution refuses and
the reference accepts), with the extra rows inside and beyond the
untrimmed output.  The conv LSTMs run with peepholes set off zero, with
the input half hoisted into one convolution and, under a cap of
``RNN_HOIST_MAX_ELEMENTS`` below the projection, step by step in both
packages.  ``SpatialConvolutionMap``'s masked weight entries get
gradients of exactly 0 and its table builders are the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import bigdl_tpu.nn as jnn

import bigdl_torch.nn as tnn
from torch_port_harness import module_bf16, module_parity, x

_RANDOM_TABLE = jnn.SpatialConvolutionMap.random(4, 5, 2, seed=3)

# name -> (constructor over either package's nn, inputs)
CASES = {
    "SpatialShareConvolution": (
        lambda nn: nn.SpatialShareConvolution(3, 4, 3, 3, 1, 1, 1, 1),
        lambda: x((2, 6, 7, 3))),
    "SpatialConvolutionMap_random": (
        lambda nn: nn.SpatialConvolutionMap(_RANDOM_TABLE, 3, 2, 1, 2, 1, 0,
                                            n_input_plane=4,
                                            n_output_plane=5),
        lambda: x((2, 7, 6, 4))),
    "SpatialConvolutionMap_one_to_one": (
        lambda nn: nn.SpatialConvolutionMap(
            nn.SpatialConvolutionMap.one_to_one(3), 3, 3, pad_w=1, pad_h=1,
            with_bias=False),
        lambda: x((2, 5, 5, 3))),
    "SpatialDilatedConvolution": (
        lambda nn: nn.SpatialDilatedConvolution(3, 4, 3, 2, 1, 2, 1, 0,
                                                dilation_w=2, dilation_h=3),
        lambda: x((2, 11, 10, 3))),
    "SpatialDilatedConvolution_same": (
        lambda nn: nn.SpatialDilatedConvolution(3, 4, 3, 3, 2, 1, -1, -1,
                                                dilation_w=2, dilation_h=2),
        lambda: x((2, 9, 8, 3))),
    "SpatialFullConvolution": (
        lambda nn: nn.SpatialFullConvolution(4, 6, 3, 3, 2, 2, 1, 1),
        lambda: x((2, 5, 4, 4))),
    "SpatialFullConvolution_groups_adj": (
        # adj = stride - 1 in both directions, two groups
        lambda nn: nn.SpatialFullConvolution(4, 6, 3, 4, 2, 3, 1, 1, 1, 2,
                                             n_group=2),
        lambda: x((2, 4, 5, 4))),
    "SpatialFullConvolution_adj_stride": (
        # adj = stride: rows past the untrimmed output (adj > pad) in H,
        # inside it (adj = pad) in W; two groups, no bias
        lambda nn: nn.SpatialFullConvolution(4, 6, 4, 3, 2, 2, 2, 1, 2, 2,
                                             n_group=2, no_bias=True),
        lambda: x((2, 4, 5, 4))),
    "SpatialFullConvolution_adj_mixed": (
        # adj = stride in W only, adj < stride in H
        lambda nn: nn.SpatialFullConvolution(3, 5, 3, 3, 3, 2, 0, 1, 3, 1),
        lambda: x((2, 3, 4, 3))),
    "TemporalConvolution": (
        lambda nn: nn.TemporalConvolution(5, 7, 3, 2),
        lambda: x((2, 11, 5))),
    "VolumetricConvolution": (
        # (k_t, k_w, k_h) = (2, 3, 2), strides (1, 2, 1), pads (1, 1, 0)
        lambda nn: nn.VolumetricConvolution(3, 4, 2, 3, 2, 1, 2, 1, 1, 1, 0),
        lambda: x((2, 5, 6, 7, 3))),
    "VolumetricConvolution_nobias": (
        lambda nn: nn.VolumetricConvolution(2, 3, 3, 3, 3, 2, 2, 2, 1, 1, 1,
                                            with_bias=False),
        lambda: x((1, 6, 5, 7, 2))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_conv_matches_reference(name):
    ctor, inputs = CASES[name]
    module_parity(ctor(jnn), ctor(tnn), inputs())


#: the bf16 forward of one case per class (the JAX side runs op by op)
BF16_CASES = ("SpatialShareConvolution", "SpatialConvolutionMap_random",
              "SpatialDilatedConvolution", "SpatialFullConvolution_adj_stride",
              "TemporalConvolution", "VolumetricConvolution")


@pytest.mark.parametrize("name", BF16_CASES)
def test_conv_bf16(name):
    ctor, inputs = CASES[name]
    module_bf16(ctor(jnn), ctor(tnn), inputs())


@pytest.mark.parametrize("stride,adj", [(2, 0), (2, 1), (2, 2), (3, 3),
                                        (1, 1)])
def test_full_convolution_output_size(stride, adj):
    """(in - 1)·stride - 2·pad + kernel + adj, the reference's formula,
    for every adj the reference takes."""
    m = tnn.SpatialFullConvolution(2, 3, 3, 3, stride, stride, 1, 1, adj,
                                   adj).build("cpu")
    y = m(torch.zeros((1, 4, 5, 2)))
    assert tuple(y.shape) == (1, 3 * stride - 2 + 3 + adj,
                              4 * stride - 2 + 3 + adj, 3)


def test_convolution_map_masked_gradients_are_zero():
    """A masked weight entry's gradient is exactly 0 (the mask applies in
    every forward), so training leaves it as it was."""
    table = tnn.SpatialConvolutionMap.random(4, 5, 2, seed=3)
    m = tnn.SpatialConvolutionMap(table, 3, 3, 1, 1, 1, 1, n_input_plane=4,
                                  n_output_plane=5).build("cpu")
    y = m(torch.from_numpy(x((2, 6, 6, 4))))
    y.square().sum().backward()
    dead = m.mask.expand_as(m.weight) == 0
    assert bool(dead.any()) and bool((~dead).any())
    assert torch.equal(m.weight.grad[dead], torch.zeros_like(
        m.weight.grad[dead]))
    assert bool((m.weight.grad[~dead] != 0).all())
    before = m.weight.detach().clone()
    with torch.no_grad():
        m.weight -= 0.1 * m.weight.grad
    assert torch.equal(m.weight[dead], before[dead])


def test_convolution_map_tables_match_reference():
    for port, ref in ((tnn.SpatialConvolutionMap.full(3, 4),
                       jnn.SpatialConvolutionMap.full(3, 4)),
                      (tnn.SpatialConvolutionMap.one_to_one(5),
                       jnn.SpatialConvolutionMap.one_to_one(5)),
                      (tnn.SpatialConvolutionMap.random(6, 4, 3, seed=9),
                       jnn.SpatialConvolutionMap.random(6, 4, 3, seed=9))):
        np.testing.assert_array_equal(port, ref)
    m = tnn.SpatialConvolutionMap(tnn.SpatialConvolutionMap.one_to_one(3),
                                  3, 3)
    assert (m.n_input_plane, m.n_output_plane) == (3, 3)
    with pytest.raises(ValueError, match="beyond plane counts"):
        tnn.SpatialConvolutionMap([[0, 4]], 3, 3, n_output_plane=2)


def test_dilated_convolution_argument_order():
    """``dilation_w`` comes before ``dilation_h``, as in the reference."""
    m = tnn.SpatialDilatedConvolution(1, 1, 3, 3, dilation_w=2,
                                      dilation_h=3)
    assert m.dilation == (3, 2) == jnn.SpatialDilatedConvolution(
        1, 1, 3, 3, dilation_w=2, dilation_h=3).dilation


def test_volumetric_weight_layout():
    """(k_t, k_w, k_h) arguments, a (kt, kh, kw, in, out) weight."""
    m = tnn.VolumetricConvolution(2, 3, 4, 5, 6).build("cpu")
    assert tuple(m.weight.shape) == (4, 6, 5, 2, 3)


def _peeped(jrec):
    """The JAX Recurrent(ConvLSTM) with its zero-initialized peepholes
    drawn off zero after each build, so the forward exercises them."""
    build = jrec.build

    def build_with_peepholes(rng=None):
        build(rng)
        cell = dict(jrec.params[0])
        for k, name in enumerate(("peep_i", "peep_f", "peep_o")):
            cell[name] = jax.random.uniform(jax.random.key(10 + k),
                                            cell[name].shape, minval=-0.5,
                                            maxval=0.5)
        jrec.params = [cell]
        return jrec
    jrec.build = build_with_peepholes
    return jrec


CONV_LSTM = {
    "ConvLSTMPeephole": (lambda nn: nn.Recurrent(nn.ConvLSTMPeephole(3, 4)),
                         lambda: x((2, 3, 5, 6, 3))),
    "ConvLSTMPeephole_k5": (
        lambda nn: nn.Recurrent(nn.ConvLSTMPeephole(2, 3, 5, 5)),
        lambda: x((2, 2, 6, 5, 2))),
    "ConvLSTMPeephole_no_peephole": (
        lambda nn: nn.Recurrent(nn.ConvLSTMPeephole(
            2, 3, 3, 3, with_peephole=False)),
        lambda: x((2, 3, 4, 4, 2))),
    "ConvLSTMPeephole3D": (
        lambda nn: nn.Recurrent(nn.ConvLSTMPeephole3D(2, 3)),
        lambda: x((2, 3, 4, 5, 4, 2))),
}


@pytest.mark.parametrize("hoist", [True, False], ids=["hoisted", "stepped"])
@pytest.mark.parametrize("name", sorted(CONV_LSTM))
def test_conv_lstm_matches_reference(name, hoist, monkeypatch):
    if not hoist:
        monkeypatch.setenv("BIGDL_TPU_RNN_HOIST_MAX_ELEMENTS", "8")
        monkeypatch.setenv("BIGDL_TORCH_RNN_HOIST_MAX_ELEMENTS", "8")
    ctor, inputs = CONV_LSTM[name]
    jm, tm = ctor(jnn), ctor(tnn)
    if "no_peephole" not in name:
        jm = _peeped(jm)
    module_parity(jm, tm, inputs())


def test_conv_lstm_hoist_cap():
    """Above the cap the projection is not hoisted; one step always is."""
    cell = tnn.ConvLSTMPeephole(2, 3).build("cpu")
    xs = torch.zeros((4, 2, 5, 5, 2))
    assert cell.project_inputs(xs) is not None
    import os
    old = os.environ.get("BIGDL_TORCH_RNN_HOIST_MAX_ELEMENTS")
    os.environ["BIGDL_TORCH_RNN_HOIST_MAX_ELEMENTS"] = "8"
    try:
        assert cell.project_inputs(xs) is None
        assert cell.project_inputs(xs[:1]) is not None
    finally:
        if old is None:
            del os.environ["BIGDL_TORCH_RNN_HOIST_MAX_ELEMENTS"]
        else:
            os.environ["BIGDL_TORCH_RNN_HOIST_MAX_ELEMENTS"] = old


def test_conv_lstm_tree_and_bare_cell():
    """The reference's param tree (peepholes float32 zeros), and a bare
    cell on one step's maps from the zero state."""
    cell = tnn.ConvLSTMPeephole3D(2, 3, 3).build("cpu")
    assert tuple(cell.kernel.shape) == (3, 3, 3, 5, 12)
    assert cell.peep_o.dtype == torch.float32 and not bool(cell.peep_o.any())
    out = cell(torch.from_numpy(x((2, 4, 3, 5, 2))))
    assert tuple(out.shape) == (2, 4, 3, 5, 3)
