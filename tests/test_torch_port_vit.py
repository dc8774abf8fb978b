"""The Vision Transformer against the JAX package, and the zoo CLI's
``vit``.

- ``ViT`` at image 32 with heads of D = 16 (4 heads of d_model 64) and
  D = 32 (2 heads), 2 layers, from the reference's weights: eval-mode
  forward, input and parameter gradients within 1e-5 (float32 both sides,
  the attention the plain version here and the Pallas kernel's reference
  route in JAX).
- Each trained 5 steps through both packages' ``Optimizer``
  (``ClassNLLCriterion``, ``SGD(0.1)``, batch 4): every loss within
  2e-3, the roadmap's training-parity bound.
- The CLI's ``vit``: the model, its input spec and its criterion as the
  reference's CLI pairs them, layer for layer; ``_NOT_PORTED`` is empty;
  ``num_experts > 0`` builds the MoE ViT, layer for layer the
  reference's, in the library and in the CLI.
"""

import numpy as np
import pytest
import torch

import jax
from bigdl_tpu import Engine as JEngine
import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import run as jrun
from bigdl_tpu.models import vit as jvit
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import run as trun
from bigdl_torch.models import vit as tvit
from bigdl_torch.optim import SGD, Optimizer, Trigger
from torch_port_harness import build_pair, module_parity, x

STEPS = 5
TRAIN_TOL = 2e-3
#: (d_model, heads): head dims 16 and 32
WIDTHS = {"d16": (64, 4), "d32": (64, 2)}


def _cfg(width):
    d, h = WIDTHS[width]
    return dict(image_size=32, patch_size=8, class_num=10, d_model=d,
                num_heads=h, num_layers=2)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_vit_forward_and_grads_match_reference(width):
    module_parity(jvit.ViT(**_cfg(width)), tvit.ViT(**_cfg(width)),
                  x((2, 32, 32, 3)))


def _recorder(trigger_cls, losses):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    return trigger_cls(fn, "record")


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_vit_trains_like_reference(width):
    jm, tm = build_pair(jvit.ViT(**_cfg(width)), tvit.ViT(**_cfg(width)))
    rs = np.random.RandomState(4)
    xs = rs.standard_normal((4 * STEPS, 32, 32, 3)).astype(np.float32)
    ys = rs.randint(0, 10, 4 * STEPS).astype(np.int32)
    jlosses, tlosses = {}, {}
    JEngine.init(devices=jax.devices()[:2])
    try:
        JOptimizer(jm, JDataSet.array([JSample.from_ndarray(a, b)
                                       for a, b in zip(xs, ys)]),
                   jnn.ClassNLLCriterion(), batch_size=4) \
            .set_optim_method(JSGD(0.1)) \
            .set_end_when(_recorder(JTrigger, jlosses)).optimize()
    finally:
        JEngine.reset()
    Optimizer(tm, DataSet.array([Sample.from_ndarray(a, b)
                                 for a, b in zip(xs, ys)]),
              tnn.ClassNLLCriterion(), batch_size=4, device="cpu") \
        .set_optim_method(SGD(0.1)) \
        .set_end_when(_recorder(Trigger, tlosses)).optimize()
    assert sorted(tlosses) == sorted(jlosses) == list(range(1, STEPS + 1))
    for k in jlosses:
        assert abs(tlosses[k] - jlosses[k]) <= TRAIN_TOL, (k, tlosses,
                                                           jlosses)
    assert tlosses[STEPS] != tlosses[1]


def _leaves(model):
    """Each layer's kind, containers with their children in order."""
    kids = getattr(model, "layers", None)
    if kids is None:
        kids = getattr(model, "modules", None)
    if kids is None or not isinstance(kids, (list, torch.nn.ModuleList)):
        return [(type(model).__name__,)]
    return [(type(model).__name__,)] + [s for c in kids for s in _leaves(c)]


def test_cli_vit_builds_like_reference():
    assert trun._NOT_PORTED == ()
    tmodel, tspec, tcrit = trun._build_model("vit", 10)
    jmodel, jspec, jcrit = jrun._build_model("vit", 10)
    assert (tspec, tcrit) == (jspec, jcrit) == ((32, 32, 3), "nll")
    assert _leaves(tmodel) == _leaves(jmodel)
    mha = [m for m in tmodel.modules()
           if isinstance(m, tnn.MultiHeadAttention)]
    assert len(mha) == 4 and {m.head_dim for m in mha} == {16}
    assert not any(m.causal for m in mha)


def test_cli_vit_forward_matches_reference():
    tmodel, _, _ = trun._build_model("vit", 10)
    jmodel, _, _ = jrun._build_model("vit", 10)
    module_parity(jmodel, tmodel, x((2, 32, 32, 3), seed=3))


def test_vit_experts_raise():
    """The MoE variants build (they raised before ``parallel/expert.py``
    was ported): the library's and the CLI's, layer for layer the
    reference's."""
    kw = dict(image_size=32, patch_size=4, num_experts=2)
    assert _leaves(tvit.ViT(**kw)) == _leaves(jvit.ViT(**kw))
    tmodel, tspec, tcrit = trun._build_model("vit", 10, num_experts=2)
    jmodel, jspec, jcrit = jrun._build_model("vit", 10, num_experts=2)
    assert (tspec, tcrit) == (jspec, jcrit)
    assert _leaves(tmodel) == _leaves(jmodel)
    assert ("MoEFFN",) in _leaves(tmodel)
