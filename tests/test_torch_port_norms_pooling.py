"""The port's extra normalizations and its 3-D and RoI pooling against
the JAX package: ``Normalize``, ``SpatialCrossMapLRN``,
``SpatialWithinChannelLRN``, ``SpatialSubtractiveNormalization``,
``SpatialDivisiveNormalization``, ``SpatialContrastiveNormalization``,
``VolumetricMaxPooling`` and ``RoiPooling``.

Each case: forward and input gradients in float32 within 1e-5 of the JAX
module's (the harness's rule); one case per class but ``RoiPooling`` also
the forward in bf16.  Odd and even
window sizes (the even ones padded asymmetrically); ``Normalize`` at
p = inf with tied maxima; ``RoiPooling`` on a map of small integers (tied
maxima in most bins, whose gradient JAX's max shares equally), with rois
that reach past the map and one that lies wholly outside it (empty bins,
which give 0).
"""

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn

import bigdl_torch.nn as tnn
from torch_port_harness import module_bf16, module_parity, x


def _tied_rows():
    """Rows whose largest magnitude appears twice (with both signs)."""
    v = x((3, 6), seed=4)
    v[:, 1] = 3.0
    v[:, 4] = -3.0
    return v


def _roi_inputs():
    feats = np.random.RandomState(7).randint(0, 3, (2, 8, 9, 3)).astype(
        np.float32)
    rois = np.array([[0, 0, 0, 8, 7],        # the whole map
                     [1, 2.5, 1.5, 6.5, 5],  # halves: round half to even
                     [1, 5, -3, 12, 4],      # past the map's edges
                     [0, 20, 20, 30, 25],    # wholly outside: every bin 0
                     [0, 3, 3, 3, 3]],       # one pixel, bins repeat it
                    np.float32)
    return [feats, rois]


CASES = {
    "Normalize_p2": (lambda nn: nn.Normalize(2.0), lambda: x((3, 5))),
    "Normalize_p1_5": (lambda nn: nn.Normalize(1.5, 1e-6),
                       lambda: x((2, 3, 5))),
    "Normalize_inf_ties": (lambda nn: nn.Normalize(np.inf),
                           _tied_rows),
    "SpatialCrossMapLRN": (lambda nn: nn.SpatialCrossMapLRN(5, 0.5, 0.75,
                                                            2.0),
                           lambda: x((2, 4, 3, 7))),
    "SpatialCrossMapLRN_even": (lambda nn: nn.SpatialCrossMapLRN(4, 1.0,
                                                                 0.6),
                                lambda: x((2, 3, 3, 6))),
    "SpatialWithinChannelLRN": (
        lambda nn: nn.SpatialWithinChannelLRN(3, 0.5, 0.75),
        lambda: x((2, 5, 6, 3))),
    "SpatialWithinChannelLRN_even": (
        lambda nn: nn.SpatialWithinChannelLRN(4, 1.0, 0.6),
        lambda: x((2, 6, 5, 2))),
    "SpatialSubtractiveNormalization": (
        lambda nn: nn.SpatialSubtractiveNormalization(3, 5),
        lambda: x((2, 7, 6, 3))),
    "SpatialSubtractiveNormalization_even": (
        lambda nn: nn.SpatialSubtractiveNormalization(2, 4),
        lambda: x((2, 5, 6, 2))),
    "SpatialDivisiveNormalization": (
        lambda nn: nn.SpatialDivisiveNormalization(3, 5),
        lambda: x((2, 7, 6, 3))),
    "SpatialDivisiveNormalization_threshold": (
        # a threshold above some local deviations: thresval replaces them
        lambda nn: nn.SpatialDivisiveNormalization(2, 3, 0.9, 0.5),
        lambda: x((2, 6, 6, 2), scale=0.8)),
    "SpatialContrastiveNormalization": (
        lambda nn: nn.SpatialContrastiveNormalization(3, 4),
        lambda: x((2, 7, 6, 3))),
    "VolumetricMaxPooling": (lambda nn: nn.VolumetricMaxPooling(2, 2, 2),
                             lambda: x((2, 4, 6, 5, 3))),
    "VolumetricMaxPooling_pad": (
        # (k_t, k_w, k_h) = (2, 3, 2), strides (1, 2, 1), pads (1, 2, 0):
        # the pad of 2 on a width-3 window is past the library's half
        lambda nn: nn.VolumetricMaxPooling(2, 3, 2, 1, 2, 1, 1, 2, 0),
        lambda: x((2, 4, 5, 6, 2))),
    "RoiPooling": (lambda nn: nn.RoiPooling(3, 2, 1.0), _roi_inputs),
    "RoiPooling_scaled": (lambda nn: nn.RoiPooling(2, 3, 0.5),
                          lambda: [x((2, 5, 6, 3)),
                                   np.array([[1, 0, 0, 11, 9],
                                             [0, 3, 2, 7, 8]], np.float32)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_norm_pool_matches_reference(name):
    ctor, inputs = CASES[name]
    module_parity(ctor(jnn), ctor(tnn), inputs())


#: the bf16 forward of one case per class (RoiPooling's JAX side, a
#: vmap run op by op, takes seconds a case, so only its float32 cases)
BF16_CASES = ("Normalize_p2", "SpatialCrossMapLRN", "SpatialWithinChannelLRN",
              "SpatialSubtractiveNormalization",
              "SpatialDivisiveNormalization",
              "SpatialContrastiveNormalization", "VolumetricMaxPooling")


@pytest.mark.parametrize("name", BF16_CASES)
def test_norm_pool_bf16(name):
    ctor, inputs = CASES[name]
    module_bf16(ctor(jnn), ctor(tnn), inputs())


def test_roi_pooling_ties_share_the_gradient():
    """A bin of four equal maxima passes a quarter of its gradient to each
    (``amax``), as JAX's max does; ``max(dim)`` would pass it to one."""
    feats = torch.zeros((1, 2, 2, 1), requires_grad=True)
    rois = torch.tensor([[0, 0, 0, 1, 1]], dtype=torch.float32)
    y = tnn.RoiPooling(1, 1).build("cpu")([feats, rois])
    y.sum().backward()
    assert torch.equal(feats.grad, torch.full_like(feats, 0.25))


def test_roi_pooling_empty_bins_are_zero():
    feats = torch.from_numpy(x((1, 4, 4, 2)) + 10.0)
    rois = torch.tensor([[0, 6, 6, 9, 9], [0, 2, 2, 6, 6]],
                        dtype=torch.float32)
    y = tnn.RoiPooling(2, 2).build("cpu")([feats, rois])
    assert torch.equal(y[0], torch.zeros_like(y[0]))
    assert bool((y[1, 0, 0] > 0).all()) and torch.equal(
        y[1, 1, 1], torch.zeros_like(y[1, 1, 1]))


def test_volumetric_pooling_default_stride():
    m = tnn.VolumetricMaxPooling(2, 3, 1)
    assert m.kernel == m.stride == (2, 1, 3)
