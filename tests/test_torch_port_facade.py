"""The port's stateful module facade and the module options of this slice,
held to the JAX package on the same numpy inputs from a seed, on the CPU.

- LeNet-5 with the reference's weights copied in: ``backward``,
  ``update_grad_input`` and ``acc_grad_parameters`` (gradients
  accumulated over two calls) within 1e-5 of the reference's (float32,
  sums in another order); ``get_parameters`` in the reference's flat
  order (weights exact, gradients within 1e-5); ``update_parameters``,
  ``set_flat_parameters``, ``zero_grad_parameters``; ``summary`` is the
  reference's text; the weights file both ways, exact.
- ``save`` / ``load``: bit-equal parameters, buffers and outputs; a JAX
  package module file raises ``ReferenceModuleFile``.
- The options: SAME convolution, ``affine=False`` BatchNorm (training and
  eval, its running statistics) and LayerNorm, ``with_bias=False``
  ``Linear`` and ``MultiHeadAttention``, ``Concat`` with ``MulConstant``,
  ``AddConstant`` and ResNet's shortcut A: forward and gradients (through
  each package's facade ``backward``) within 1e-5.  The deterministic
  initializers are exact; the random ones draw from the given generator.
- ResNet-20 (CIFAR, shortcut A) trained 5 steps by each package's
  ``Optimizer`` from the same weights: losses within 2e-3 (BatchNorm
  statistics and the bf16 gradient wire round in another order).
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
from bigdl_tpu.models import LeNet5 as JLeNet5
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim.trigger import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import LeNet5 as TLeNet5
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.utils.convert import load_reference_tree

TOL = 1e-5
LOSS_TOL = 2e-3


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    from bigdl_tpu.common import get_default_rng
    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _copy(jm, tm):
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    return tm


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= tol * max(
        1.0, float(np.max(np.abs(b), initial=0.0)))


def _lenet(seed=2):
    jm = JLeNet5(10).build(jax.random.key(seed))
    return jm, _copy(jm, TLeNet5(10).build("cpu"))


def _io(shape, out_shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal(shape).astype(np.float32),
            rs.standard_normal(out_shape).astype(np.float32))


def test_lenet_facade_like_reference():
    jm, tm = _lenet()
    x, g = _io((4, 28, 28, 1), (4, 10))
    _close(tm.update_output(torch.tensor(x)), jm.forward(jnp.asarray(x)))
    _close(tm.output, jm.output)
    for _ in range(2):   # gradients accumulate
        _close(tm.backward(torch.tensor(x), torch.tensor(g)),
               jm.backward(jnp.asarray(x), jnp.asarray(g)))
    tw, tg = tm.get_parameters()
    jw, jg = jm.get_parameters()
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    _close(tg, jg)
    _close(tm.update_grad_input(torch.tensor(x), torch.tensor(g)),
           jm.update_grad_input(jnp.asarray(x), jnp.asarray(g)))
    tm.acc_grad_parameters(torch.tensor(x), torch.tensor(g))
    jm.acc_grad_parameters(jnp.asarray(x), jnp.asarray(g))
    _close(tm.get_parameters()[1], jm.get_parameters()[1])
    ws, gs = tm.weights_and_grads()
    jws, jgs = jm.parameters()
    assert [tuple(w.shape) for w in ws] == [w.shape for w in jws]
    tm.update_parameters(0.1)
    jm.update_parameters(0.1)
    _close(tm.get_parameters()[0], jm.get_parameters()[0])
    tm.zero_grad_parameters()
    assert not tm.get_parameters()[1].any()
    flat = tm.get_parameters()[0] * 2
    tm.set_flat_parameters(flat)
    assert torch.equal(tm.get_parameters()[0], flat)
    assert tm.summary(print_fn=None) == jm.summary(print_fn=None)
    assert list(tm.get_parameters_table()) == [tm.name]
    assert [m for m, _, _ in tm.get_times()][0] is tm
    assert tm.is_training()
    tm.evaluate()
    assert not tm.is_training()


def test_weights_files_both_ways(tmp_path):
    jm, tm = _lenet()
    jm2, tm2 = _lenet(seed=5)
    tm.save_weights(str(tmp_path / "t.w"))
    jm2.load_weights(str(tmp_path / "t.w"))
    jm.save_weights(str(tmp_path / "j.w"))
    tm2.load_weights(str(tmp_path / "j.w"))
    for a, b in zip(tm2.get_weights_bias(), jm2.get_weights_bias()):
        assert np.array_equal(a, b)
    tm2.load_model_weights(tm)
    assert torch.equal(tm2.get_parameters()[0], tm.get_parameters()[0])
    with pytest.raises(ValueError):
        tm.set_weights_bias(tm.get_weights_bias()[:-1])


def test_save_load_round_trip(tmp_path):
    m = tresnet.ResNet(20, class_num=10, dataset="cifar10").build(
        "cpu", torch.Generator().manual_seed(0))
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    m(x)   # moves the running statistics
    m.update_output(x)
    m.evaluate()
    want = m(x)
    m.save(str(tmp_path / "m"))
    back = tnn.Module.load(str(tmp_path / "m"), device="cpu")
    assert type(back) is type(m) and not back.training
    assert back.output is None and m.output is not None
    for (n, a), (_, b) in zip(m.state_dict().items(),
                              back.state_dict().items()):
        assert torch.equal(a, b), n
    assert [p.requires_grad for p in back.parameters()] == \
        [p.requires_grad for p in m.parameters()]
    assert torch.equal(back(x), want)
    clone = m.clone_module()
    assert torch.equal(clone(x), want)
    jm = JLeNet5(10).build(jax.random.key(0))
    jm.save(str(tmp_path / "ref"))
    with pytest.raises(tnn.ReferenceModuleFile, match="load_reference_tree"):
        tnn.Module.load(str(tmp_path / "ref"), device="cpu")
    for fn in (m.save_caffe, m.save_tf, m.save_torch):
        with pytest.raises(NotImplementedError, match="item 9"):
            fn("x")


def _options():
    """name -> (kind, input shape, output shape)."""
    return {
        "same_3x3_s1": ("same", (2, 9, 9, 3), (2, 9, 9, 4)),
        "same_4x4_s2": ("same", (2, 9, 10, 3), (2, 5, 5, 4)),
        "same_5x5_s3": ("same", (2, 8, 8, 3), (2, 3, 3, 4)),
        "bn_no_affine": ("bn", (4, 5, 5, 6), (4, 5, 5, 6)),
        "ln_no_affine": ("ln", (3, 7, 8), (3, 7, 8)),
        "linear_no_bias": ("linear", (5, 12), (5, 7)),
        "mha_no_bias": ("mha", (2, 6, 16), (2, 6, 16)),
        "concat_mulconst": ("concat", (2, 4, 4, 3), (2, 4, 4, 6)),
        "addconst": ("add", (3, 5), (3, 5)),
        "shortcut_a": ("shortcut", (2, 8, 8, 4), (2, 4, 4, 8)),
    }


def _build_option(nn, mod, kind):
    return {
        "bn": lambda: nn.SpatialBatchNormalization(6, affine=False),
        "ln": lambda: nn.LayerNorm(8, affine=False),
        "linear": lambda: nn.Linear(12, 7, with_bias=False),
        "mha": lambda: nn.MultiHeadAttention(16, 4, with_bias=False),
        "concat": lambda: nn.Concat(-1).add(nn.Identity()).add(
            nn.MulConstant(0.5)),
        "add": lambda: nn.AddConstant(1.5),
        "shortcut": lambda: mod._shortcut(4, 8, 2, "A"),
    }[kind]()


SAME = {"same_3x3_s1": (3, 1), "same_4x4_s2": (4, 2), "same_5x5_s3": (5, 3)}


@pytest.mark.parametrize("name", list(_options()))
@pytest.mark.parametrize("training", [True, False])
def test_module_option_like_reference(name, training):
    _, in_shape, out_shape = _options()[name]
    if name in SAME:
        k, s = SAME[name]
        jm = jnn.SpatialConvolution(3, 4, k, k, s, s, -1, -1)
        tm = tnn.SpatialConvolution(3, 4, k, k, s, s, -1, -1)
    else:
        kind = _options()[name][0]
        jm = _build_option(jnn, jresnet, kind)
        tm = _build_option(tnn, tresnet, kind)
    jm.build(jax.random.key(4))
    tm.build("cpu")
    _copy(jm, tm)
    if name == "bn_no_affine":
        rs = np.random.RandomState(3)
        st = {"running_mean": rs.standard_normal(6).astype(np.float32),
              "running_var": rs.uniform(0.5, 2, 6).astype(np.float32)}
        jm.state = jax.tree.map(jnp.asarray, st)
        load_reference_tree(tm, {}, st)
    if not training:
        jm.evaluate()
        tm.evaluate()
    x, g = _io(in_shape, out_shape, seed=7)
    _close(tm.update_output(torch.tensor(x)), jm.forward(jnp.asarray(x)))
    _close(tm.backward(torch.tensor(x), torch.tensor(g)),
           jm.backward(jnp.asarray(x), jnp.asarray(g)))
    _close(tm.get_parameters()[1], jm.get_parameters()[1])
    if name == "bn_no_affine":
        assert tm.param_names == () and jm.params == {}
        _close(tm.running_mean, jm.state["running_mean"])
        _close(tm.running_var, jm.state["running_var"])


def test_deterministic_initializers_exact():
    from bigdl_tpu.nn import initialization as ji
    from bigdl_torch.nn import initialization as ti
    for shape in ((4, 4, 2, 3), (3, 5, 1, 1), (1, 1, 2, 2)):
        for jf, tf in ((ji.Zeros(), ti.Zeros()), (ji.Ones(), ti.Ones()),
                       (ji.ConstInitMethod(0.37), ti.ConstInitMethod(0.37)),
                       (ji.BilinearFiller(), ti.BilinearFiller())):
            want = np.asarray(jf(jax.random.key(0), shape))
            got = tf(torch.Generator(), shape).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    for init, lo, hi in ((ti.RandomUniform(), -0.5, 0.5),
                         (ti.RandomUniform(-2.0, -1.0), -2.0, -1.0),
                         (ti.Xavier(), -np.sqrt(6 / 7), np.sqrt(6 / 7))):
        a = init(gen(), (3, 4))
        assert torch.equal(a, init(gen(), (3, 4)))
        assert lo <= float(a.min()) and float(a.max()) <= hi
    r = ti.RandomNormal(2.0, 0.5)(gen(), (4000,))
    assert abs(float(r.mean()) - 2.0) < 0.05 and torch.equal(
        r, ti.RandomNormal(2.0, 0.5)(gen(), (4000,)))
    lin = tnn.Linear(3, 4).set_init_method(ti.Ones(), ti.ConstInitMethod(2))
    lin.build("cpu")
    assert bool((lin.weight == 1).all()) and bool((lin.bias == 2).all())


def test_resnet20_shortcut_a_trains_like_reference():
    rs = np.random.RandomState(11)
    x = rs.standard_normal((40, 32, 32, 3)).astype(np.float32)
    y = rs.randint(0, 10, 40).astype(np.int32)
    jm = jresnet.ResNet(20, class_num=10, dataset="cifar10")
    jm.build(jax.random.key(6))
    tm = _copy(jm, tresnet.ResNet(20, class_num=10,
                                  dataset="cifar10").build("cpu"))
    assert sum("MulConstant" in type(m).__name__ for m in tm.modules()) == 2
    JEngine.init()
    losses = {}
    for name, (Opt, DS, S, nn, SGD, Trigger, kw) in {
            "jax": (JOptimizer, JDataSet, JSample, jnn, JSGD, JTrigger, {}),
            "torch": (TOptimizer, TDataSet, TSample, tnn, TSGD, TTrigger,
                      {"device": "cpu"})}.items():
        seen = {}

        def end(state, seen=seen):
            if state["neval"] > 1:
                seen[state["neval"] - 1] = state["loss"]
            return state["neval"] > 5
        opt = Opt(jm if name == "jax" else tm,
                  DS.array([S(a, b) for a, b in zip(x, y)]),
                  nn.CrossEntropyCriterion(), batch_size=8, **kw)
        opt.set_optim_method(SGD(0.05, momentum=0.9))
        opt.set_end_when(Trigger(end, "steps")).optimize()
        losses[name] = [seen[k] for k in sorted(seen)]
    assert len(losses["torch"]) == 5
    assert np.max(np.abs(np.subtract(losses["torch"], losses["jax"]))) \
        <= LOSS_TOL, losses
