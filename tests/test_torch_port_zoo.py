"""The image and text zoo built on the slice's layers against the JAX
package: ``Inception_Layer_v1`` / ``_v2``, ``Inception_v1`` /
``_v1_NoAuxClassifier``, ``Inception_v2`` / ``_v2_NoAuxClassifier``,
``AlexNet``, ``VggForCifar10``, ``Vgg_16`` / ``Vgg_19``,
``TextClassifier`` (with its ``TemporalMaxPooling``) and the zoo CLI's
new names.

- The Inception blocks at narrow widths on 16 x 16 maps, from the
  reference's weights: eval-mode forward and gradients within 1e-5, and
  BN-Inception's block in training mode, fused (``fuse_conv_bn``: its 1x1
  pairs on the conv-BN kernels' plain versions) and unfused, against the
  JAX block on its own route, within 1e-5.
- The whole ``Inception_v1_NoAuxClassifier`` and
  ``Inception_v2_NoAuxClassifier`` (1000 classes) forward at batch 1,
  224 x 224, eval mode, within 1e-5; the aux-head models' output is
  [main | aux2 | aux1], checked on their layer structure.
- ``VggForCifar10`` (batch 4, ``SGD(1e-5)``) and ``TextClassifier``
  (batch 4, seq 160, and with a ``LookupTable`` front, ``SGD(0.1)``)
  trained 5 steps through both packages' ``Optimizer`` (Dropout at
  p = 0 in both: the two
  packages draw different masks), each loss within 2e-3 (the roadmap's
  training-parity bound).  The batches are cut to fit the CPU; the widths
  are the models' own.
- ``AlexNet``, ``Vgg_16`` and ``Vgg_19`` at full width on structure alone
  (each layer's kind, shape-defining attributes and name), without
  allocating their weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import alexnet as jalexnet
from bigdl_tpu.models import inception as jinc
from bigdl_tpu.models import run as jrun
from bigdl_tpu.models import textclassifier as jtext
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import alexnet as talexnet
from bigdl_torch.models import inception as tinc
from bigdl_torch.models import run as trun
from bigdl_torch.models import textclassifier as ttext
from bigdl_torch.models import vgg as tvgg
from bigdl_torch.optim import SGD, Optimizer, Trigger
from bigdl_torch.utils.convert import to_reference_tree
from torch_port_harness import build_pair, close, module_parity, x

STEPS = 5
TRAIN_TOL = 2e-3

V1_CFG = (8, ((4,), (4, 6), (2, 3), (3,)), "t/")
V2_CFGS = {
    "avg": (8, ((4,), (4, 6), (2, 3), ("avg", 3)), "t/"),
    "max_proj": (8, ((4,), (4, 6), (2, 3), ("max", 3)), "t/"),
    "reduction": (8, ((0,), (4, 6), (2, 3), ("max", 0)), "t/"),
}


def test_inception_layer_v1_matches_reference():
    module_parity(jinc.Inception_Layer_v1(*V1_CFG),
                  tinc.Inception_Layer_v1(*V1_CFG), x((2, 16, 16, 8)))


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", sorted(V2_CFGS))
def test_inception_layer_v2_eval_matches_reference(kind, fuse):
    jm = jinc.Inception_Layer_v2(*V2_CFGS[kind])
    tm = tinc.Inception_Layer_v2(*V2_CFGS[kind])
    if fuse:
        jnn.fuse_conv_bn(jm)
        tnn.fuse_conv_bn(tm)
    module_parity(jm, tm, x((2, 16, 16, 8)))


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_inception_layer_v2_trains_like_reference(fuse):
    """Training mode (batch statistics; the 1x1 pairs fused into ConvBN):
    output, input and parameter gradients and the running statistics
    after one forward."""
    cfg = V2_CFGS["avg"]
    jm, tm = jinc.Inception_Layer_v2(*cfg), tinc.Inception_Layer_v2(*cfg)
    if fuse:
        jnn.fuse_conv_bn(jm)
        tnn.fuse_conv_bn(tm)
        assert sum(type(m).__name__ == "ConvBN" for m in tm.modules()) == 4
    build_pair(jm, tm)
    xs = x((4, 16, 16, 8))
    ct = x((4, 16, 16, 4 + 6 + 3 + 3), seed=5)

    @jax.jit
    def forward_and_vjp(p, xx, c):
        (y, state), vjp = jax.vjp(
            lambda p_, x_: jm.apply(p_, jm.state, x_, training=True), p, xx)
        return y, state, vjp((c, jax.tree.map(jnp.zeros_like, state)))

    jy, jstate, (jgp, jgx) = forward_and_vjp(jm.params, jnp.asarray(xs),
                                             jnp.asarray(ct))
    tx = torch.from_numpy(xs).requires_grad_()
    ty = tm.train()(tx)
    ty.backward(torch.from_numpy(ct))
    close(ty, jy, what="output")
    close(tx.grad, jgx, what="input grad")
    leaves = tm._leaf_names()
    jgrads = jax.tree.leaves(jgp)
    assert len(leaves) == len(jgrads)
    bounds = iter(_bias_bounds(cfg, tm, xs, ct))
    for (mod, name), b in zip(leaves, jgrads):
        a = getattr(mod, name).grad
        if name == "bias" and isinstance(mod, tnn.SpatialConvolution):
            # BatchNorm takes out the bias before it: both gradients are
            # 0 but for float32 rounding in their sums over the rows
            bound = next(bounds)
            assert float(a.abs().max()) <= bound
            assert float(np.abs(np.asarray(b)).max()) <= bound
        else:
            close(a, b, what=f"{type(mod).__name__}.{name} grad")
    for a, b in zip(jax.tree.leaves(to_reference_tree(tm)[1]),
                    jax.tree.leaves(jstate)):
        close(a, b, what="running statistics")


def _bias_bounds(cfg, tm, xs, ct):
    """Per convolution (in leaf order), the float32 bound on a sum of the
    rows' terms whose exact value is 0, taken twice (the terms are
    rounded too): 2 (rows - 1) 2^-24 Σ|dz|, dz the gradient at the
    convolution's output in the unfused block on ``tm``'s weights."""
    m = tinc.Inception_Layer_v2(*cfg).build("cpu")
    m.set_weights_bias(tm.get_weights_bias())
    convs = [c for c, n in m._leaf_names()
             if n == "bias" and isinstance(c, tnn.SpatialConvolution)]
    grads = {}

    def keep_grad(mod, inp, out):
        out.register_hook(lambda g: grads.__setitem__(mod, g))
    for c in convs:
        c.register_forward_hook(keep_grad)
    m.train()(torch.from_numpy(xs)).backward(torch.from_numpy(ct))
    out = []
    for c in convs:
        dz = grads[c].reshape(-1, c.n_output_plane)
        out.append(2 * (dz.shape[0] - 1) * 2.0 ** -24 *
                   float(dz.abs().sum(0).max()))
    return out


@pytest.mark.parametrize("name", ["Inception_v1_NoAuxClassifier",
                                  "Inception_v2_NoAuxClassifier"])
def test_whole_inception_forward_matches_reference(name):
    """Full width, 1000 classes, batch 1 at 224 x 224, eval mode.  The
    port's seeded weights go to the JAX model (its own init takes 13 to
    20 s on this CPU), after its trees' structure and shapes are held to
    the reference's init's."""
    jm, tm = getattr(jinc, name)(1000), getattr(tinc, name)(1000).build("cpu")
    params, state = to_reference_tree(tm)
    want = jax.eval_shape(jm.init, jax.random.key(0))
    assert jax.tree.structure(want) == jax.tree.structure((params, state))
    assert [a.shape for a in jax.tree.leaves(want)] == \
        [a.shape for a in jax.tree.leaves((params, state))]
    jm.params, jm.state = jax.tree.map(jnp.asarray, (params, state))
    xs = x((1, 224, 224, 3))
    jy = jax.jit(lambda p, s, xx: jm.apply(p, s, xx, training=False)[0])(
        jm.params, jm.state, jnp.asarray(xs))
    with torch.inference_mode():
        ty = tm.eval()(torch.from_numpy(xs))
    assert tuple(ty.shape) == (1, 1000)
    close(ty, jy, what=name)


def _signature(m):
    """A layer's kind, its shape-defining attributes and its name where
    the reference names it (``<Class>_<n>`` names are a counter's)."""
    keys = ("n_input_plane", "n_output_plane", "kernel", "stride", "pad",
            "n_group", "input_size", "output_size", "n_output", "eps",
            "size", "alpha", "beta", "k", "dimension", "p", "ceil_mode",
            "shape", "global_pooling", "with_bias")
    attrs = tuple((k, getattr(m, k)) for k in keys if hasattr(m, k)
                  and not callable(getattr(m, k)))
    name = m.get_name()
    return (type(m).__name__, attrs,
            None if name.startswith(type(m).__name__ + "_") else name)


def _leaves(model):
    kids = getattr(model, "layers", None)
    if kids is None:
        kids = getattr(model, "modules", None)
    if kids is None or not isinstance(kids, (list, torch.nn.ModuleList)):
        return [_signature(model)]
    return [(type(model).__name__,)] + [s for c in kids for s in _leaves(c)]


@pytest.mark.parametrize("build", [
    "alexnet.AlexNet", "vgg.Vgg_16", "vgg.Vgg_19", "vgg.VggForCifar10",
    "inception.Inception_v1", "inception.Inception_v2"])
def test_model_structure_matches_reference(build):
    mod, fn = build.split(".")
    tmods = {"alexnet": talexnet, "vgg": tvgg, "inception": tinc}
    jmods = {"alexnet": jalexnet, "vgg": jvgg, "inception": jinc}
    assert _leaves(getattr(tmods[mod], fn)(1000)) == \
        _leaves(getattr(jmods[mod], fn)(1000))


def test_inception_aux_output_is_main_aux2_aux1():
    """[main | aux2 | aux1] along the class axis: the main tower is the
    first child of the inner Concat, the aux heads follow in that
    order."""
    for m in (tinc.Inception_v1(7), tinc.Inception_v2(7)):
        feature1, split1 = m.layers
        main_branch, aux1 = split1.layers
        feature2, split2 = main_branch.layers
        main, aux2 = split2.layers
        assert aux1.layers[1].get_name().startswith("loss1/")
        assert aux2.layers[1].get_name().startswith("loss2/")
        assert main.layers[-2].get_name() == "loss3/classifier"


def _recorder(trigger_cls, losses):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    return trigger_cls(fn, "record")


def _no_dropout(model):
    for m in model.modules() if isinstance(model, torch.nn.Module) \
            else _jax_modules(model):
        if type(m).__name__ == "Dropout":
            m.set_p(0.0)
    return model


def _jax_modules(m):
    yield m
    for c in getattr(m, "modules", []) or []:
        yield from _jax_modules(c)


def _train_both(jm, tm, xs, ys, batch, lr=0.1):
    jm, tm = _no_dropout(jm), _no_dropout(tm)
    build_pair(jm, tm)
    jlosses, tlosses = {}, {}
    JEngine.init(devices=jax.devices()[:2])
    try:
        JOptimizer(jm, JDataSet.array([JSample.from_ndarray(a, b)
                                       for a, b in zip(xs, ys)]),
                   jnn.ClassNLLCriterion(), batch_size=batch) \
            .set_optim_method(JSGD(lr)) \
            .set_end_when(_recorder(JTrigger, jlosses)).optimize()
    finally:
        JEngine.reset()
    Optimizer(tm, DataSet.array([Sample.from_ndarray(a, b)
                                 for a, b in zip(xs, ys)]),
              tnn.ClassNLLCriterion(), batch_size=batch, device="cpu") \
        .set_optim_method(SGD(lr)) \
        .set_end_when(_recorder(Trigger, tlosses)).optimize()
    assert sorted(tlosses) == sorted(jlosses) == list(range(1, STEPS + 1))
    for k in jlosses:
        assert np.isfinite(tlosses[k])
        assert abs(tlosses[k] - jlosses[k]) <= TRAIN_TOL, (k, tlosses,
                                                           jlosses)
    assert tlosses[STEPS] != tlosses[1]


def test_vgg_for_cifar10_trains_like_reference():
    """At ``SGD(1e-5)``.  At this init BatchNorm's scale-free conv
    weights get gradients 8 to 30 times their norm, so at 0.01 or 1e-3 a
    relative change of 1e-7 in the weights moves the port's own third
    loss by 0.08 to 0.17, and at 1e-4 a max-pool or ReLU routing flip
    moved the fifth loss by 7.5e-3: the run is chaotic there, whichever
    package computes it.  At 1e-5 the updates still move losses 2 to 5
    by 2.8e-3 to 7.6e-3 against a run that does not update."""
    rs = np.random.RandomState(2)
    xs = rs.standard_normal((4 * STEPS, 32, 32, 3)).astype(np.float32)
    ys = rs.randint(0, 10, 4 * STEPS).astype(np.int32)
    _train_both(jvgg.VggForCifar10(10), tvgg.VggForCifar10(10), xs, ys, 4,
                lr=1e-5)


@pytest.mark.parametrize("vocab", [None, 50], ids=["vectors", "tokens"])
def test_text_classifier_trains_like_reference(vocab):
    """Width 200, 128 filters; seq 160 (the stack's least is 149)."""
    rs = np.random.RandomState(3)
    if vocab is None:
        xs = rs.standard_normal((4 * STEPS, 160, 200)).astype(np.float32)
    else:
        xs = rs.randint(0, vocab, (4 * STEPS, 160)).astype(np.int32)
    ys = rs.randint(0, 5, 4 * STEPS).astype(np.int32)
    _train_both(jtext.TextClassifier(5, vocab_size=vocab),
                ttext.TextClassifier(5, vocab_size=vocab), xs, ys, 4)


def test_temporal_max_pooling_matches_reference():
    module_parity(jtext.TemporalMaxPooling(5, 3),
                  ttext.TemporalMaxPooling(5, 3),
                  np.round(x((2, 17, 4)) * 2) / 2)   # ties in the windows


@pytest.mark.parametrize("name", ["inception", "inception_v2", "alexnet",
                                  "vgg", "vgg16", "vgg19"])
def test_cli_builds_new_models_like_reference(name):
    """The model, its input spec and its criterion, as the reference's
    CLI pairs them."""
    tmodel, tspec, tcrit = trun._build_model(name, 10)
    jmodel, jspec, jcrit = jrun._build_model(name, 10)
    assert (tspec, tcrit) == (jspec, jcrit)
    assert _leaves(tmodel) == _leaves(jmodel)
    assert type(trun.build_criterion(tcrit)).__name__ == \
        type(jrun.build_criterion(jcrit)).__name__


def test_cli_vit_still_raises():
    """Every model of the reference's CLI is ported: ``vit`` builds as
    the reference's does (its parity is ``test_torch_port_vit.py``'s)."""
    assert trun._NOT_PORTED == ()
    tmodel, tspec, tcrit = trun._build_model("vit", 10)
    jmodel, jspec, jcrit = jrun._build_model("vit", 10)
    assert (tspec, tcrit) == (jspec, jcrit)
    assert _leaves(tmodel) == _leaves(jmodel)


def test_alexnet_forward_shape():
    """227 x 227 through the grouped convolutions and LRNs to 6 x 6 x 256
    (a narrow head keeps the weights small)."""
    m = talexnet.AlexNet(10)
    feats = tnn.Sequential(*list(m.layers)[:15]).build("cpu")
    with torch.inference_mode():
        y = feats.eval()(torch.zeros((1, 227, 227, 3)))
    assert tuple(y.shape) == (1, 6, 6, 256)
