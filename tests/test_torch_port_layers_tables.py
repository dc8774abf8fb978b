"""The port's shape layers and table layers against the JAX package.

One parametrised case per class (and per option that changes the
arithmetic): forward, input gradient and parameter gradients in float32
within 1e-5, and the forward in bf16 (output dtype and 0.05 absolute +
0.02 relative), as ``torch_port_harness.py`` states.  Axis, offset and
index arguments are the reference's 0-based ones.  ``MaskedSelect`` is
held to the reference's eager result, ``t[mask]`` (its traced form, a
fixed-size packed vector, has no counterpart in the eager port).
"""

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn

import bigdl_torch.nn as tnn
from torch_port_harness import labels, module_bf16, module_parity, x

_MASK = x((3, 4), 7) > 0


def _masked_select_ref(params, inputs):
    return inputs[0][np.asarray(inputs[1], bool)]


def _mixture_inputs():
    g = x((2, 3), 3)
    gate = np.exp(g) / np.exp(g).sum(-1, keepdims=True)
    return [gate.astype(np.float32), [x((2, 4), 10 + i) for i in range(3)]]


# name -> (constructor over either package's nn, inputs[, JAX stand-in])
CASES = {
    # shape
    "Reshape": (lambda nn: nn.Reshape((3, 4)), lambda: x((2, 12))),
    "InferReshape": (lambda nn: nn.InferReshape((0, -1)),
                     lambda: x((2, 3, 4))),
    "InferReshape_batch": (lambda nn: nn.InferReshape((-1, 2), True),
                           lambda: x((2, 3, 4))),
    "View": (lambda nn: nn.View(2, 3, 4), lambda: x((2, 12))),
    "View_batch": (lambda nn: nn.View(-1, 4), lambda: x((2, 3, 4))),
    "Transpose": (lambda nn: nn.Transpose([(1, 2), (0, 1)]),
                  lambda: x((2, 3, 4))),
    "Replicate": (lambda nn: nn.Replicate(3, 1), lambda: x((2, 4))),
    "Squeeze": (lambda nn: nn.Squeeze(1), lambda: x((2, 1, 4))),
    "Squeeze_all": (lambda nn: nn.Squeeze(), lambda: x((2, 1, 4, 1))),
    "Unsqueeze": (lambda nn: nn.Unsqueeze(1), lambda: x((2, 4))),
    "Select": (lambda nn: nn.Select(1, -1), lambda: x((2, 3, 4))),
    "Narrow": (lambda nn: nn.Narrow(1, 1, 2), lambda: x((2, 5, 4))),
    "Narrow_negative": (lambda nn: nn.Narrow(1, 1, -2),
                        lambda: x((2, 5, 4))),
    "Index": (lambda nn: nn.Index(0),
              lambda: [x((5, 3)), np.array([3, 1, 3], np.int32)]),
    "Index_axis1": (lambda nn: nn.Index(1),
                    lambda: [x((2, 5, 3)), np.array([4, 0], np.int32)]),
    "MaskedSelect": (lambda nn: nn.MaskedSelect(),
                     lambda: [x((3, 4)), _MASK.astype(np.int32)],
                     _masked_select_ref),
    "Reverse": (lambda nn: nn.Reverse(1), lambda: x((2, 3, 4))),
    "Padding": (lambda nn: nn.Padding(1, 2, value=0.5),
                lambda: x((2, 3, 4))),
    "Padding_front": (lambda nn: nn.Padding(2, -1), lambda: x((2, 3, 4))),
    "SpatialZeroPadding": (lambda nn: nn.SpatialZeroPadding(1, 2, 0, 1),
                           lambda: x((2, 3, 4, 2))),
    "Contiguous": (lambda nn: nn.Contiguous(), lambda: x((2, 3))),
    # tables
    "CAddTable": (lambda nn: nn.CAddTable(),
                  lambda: [x((3, 4)), x((3, 4), 1), x((3, 4), 2)]),
    "CSubTable": (lambda nn: nn.CSubTable(),
                  lambda: [x((3, 4)), x((3, 4), 1)]),
    "CMulTable": (lambda nn: nn.CMulTable(),
                  lambda: [x((3, 4)), x((3, 4), 1), x((3, 4), 2)]),
    "CDivTable": (lambda nn: nn.CDivTable(),
                  lambda: [x((3, 4)), x((3, 4), 1, positive=True)]),
    "CMaxTable": (lambda nn: nn.CMaxTable(),
                  lambda: [x((3, 4)), x((3, 4), 1), x((3, 4), 2)]),
    "CMinTable": (lambda nn: nn.CMinTable(),
                  lambda: [x((3, 4)), x((3, 4), 1)]),
    "JoinTable": (lambda nn: nn.JoinTable(1),
                  lambda: [x((2, 3)), x((2, 4), 1)]),
    "JoinTable_last": (lambda nn: nn.JoinTable(-1, 2),
                       lambda: [x((2, 3, 1)), x((2, 3, 2), 1)]),
    "SplitTable": (lambda nn: nn.SplitTable(1), lambda: x((2, 3, 4))),
    "NarrowTable": (lambda nn: nn.NarrowTable(1, 2),
                    lambda: [x((2, 3)), x((2, 3), 1), x((2, 3), 2)]),
    "NarrowTable_negative": (lambda nn: nn.NarrowTable(0, -2),
                             lambda: [x((2, 3)), x((2, 3), 1),
                                      x((2, 3), 2)]),
    "FlattenTable": (lambda nn: nn.FlattenTable(),
                     lambda: [x((3, 4)), [x((3, 4), 1), [x((2, 2), 2)]]]),
    "SelectTable": (lambda nn: nn.SelectTable(2),
                    lambda: [x((2, 3)), x((2, 4), 1), x((2, 5), 2)]),
    "MixtureTable": (lambda nn: nn.MixtureTable(), _mixture_inputs),
    "MixtureTable_tensor": (lambda nn: nn.MixtureTable(),
                            lambda: [x((2, 3), 3), x((2, 3, 4), 4)]),
    "Pack": (lambda nn: nn.Pack(1),
             lambda: [x((2, 3)), x((2, 3), 1), x((2, 3), 2)]),
    "Pack_tensor": (lambda nn: nn.Pack(0), lambda: x((2, 3))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_reference(name):
    ctor, inputs, *ref = CASES[name]
    module_parity(ctor(jnn), ctor(tnn), inputs(),
                  jax_fn=ref[0] if ref else None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_bf16(name):
    ctor, inputs, *ref = CASES[name]
    module_bf16(ctor(jnn), ctor(tnn), inputs(),
                jax_fn=ref[0] if ref else None)


def test_masked_select_is_eager_compaction():
    """The eager result has exactly the mask's count of elements, in row
    order (the reference outside ``jit``)."""
    t = torch.from_numpy(x((3, 4)))
    out = tnn.MaskedSelect().build("cpu")([t, torch.from_numpy(_MASK)])
    assert out.shape == (int(_MASK.sum()),)
    assert torch.equal(out, t[torch.from_numpy(_MASK)])


def test_squeeze_of_a_wide_axis_raises():
    """As ``jnp.squeeze``, an axis that is not of size 1 is refused."""
    with pytest.raises(ValueError, match="size 1"):
        tnn.Squeeze(1).build("cpu")(torch.zeros((2, 3)))


def test_index_keeps_the_index_shape():
    t = torch.from_numpy(x((5, 3)))
    idx = torch.from_numpy(labels((2, 2), 5))
    out = tnn.Index(0).build("cpu")([t, idx])
    assert out.shape == (2, 2, 3)
    assert torch.equal(out, t[idx.long()])
