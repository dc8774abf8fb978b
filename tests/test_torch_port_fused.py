"""The fused update (``optim/fused.py``, ``OptimMethod.update_fused``,
``BIGDL_TORCH_FUSED_UPDATE``) against the port's per-leaf update and the
JAX package's fused update.

Tolerances:
- fused against per-leaf, in the port: bit-equal, parameters and every
  state tensor after three updates.  Every method that fuses is
  elementwise, so each element goes through the same float32 operations.
- the port's fused update against the reference's ``update_fused`` on the
  same seeded parameters and gradients: 1e-6 relative to
  max(1, max|reference|) after three updates (the two packages' float32
  kernels may differ in the last bit of a division or square root).
- training the small ResNet with and without the knob: bit-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bigdl_tpu.optim as jopt
from bigdl_tpu.optim import fused as jfused

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.optim import (EMA, LBFGS, SGD, Adadelta, Adagrad, Adam,
                               Adamax, Optimizer, RMSprop, Trigger)
from bigdl_torch.optim.fused import FusedLayout, fuse, plan, unfuse

from test_torch_port_dp import _data, _small_resnet

REF_RTOL = 1e-6
LR = 0.05
SHAPES = [(7, 7, 3, 16), (16,), (30, 40), (5,), (1, 1, 64, 32), (3,)]

_METHODS = {
    "sgd": lambda m: m.SGD(0.1, momentum=0.9, weight_decay=1e-4),
    "sgd_nesterov": lambda m: m.SGD(0.1, momentum=0.9, dampening=0.0,
                                    nesterov=True),
    "adam": lambda m: m.Adam(1e-2),
    "adagrad": lambda m: m.Adagrad(1e-2, weight_decay=1e-3),
    "adadelta": lambda m: m.Adadelta(),
    "adamax": lambda m: m.Adamax(),
    "rmsprop": lambda m: m.RMSprop(1e-2),
    "ema": lambda m: m.EMA(m.Adam(1e-2), 0.9),
}


class _Torch:
    SGD, Adam, Adagrad, Adadelta, Adamax, RMSprop, EMA = (
        SGD, Adam, Adagrad, Adadelta, Adamax, RMSprop, EMA)


def _arrays(seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in SHAPES]


def _flat(state):
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _flat(state[k])]
    if isinstance(state, (list, tuple)):
        return [t for v in state for t in _flat(v)]
    return [torch.as_tensor(np.asarray(state))]


def _port(name, fused, steps=3):
    method = _METHODS[name](_Torch)
    params = [torch.from_numpy(a) for a in _arrays(0)]
    state = method.init_state(params)
    for i in range(steps):
        grads = [torch.from_numpy(a) for a in _arrays(i + 1)]
        update = method.update_fused if fused else method.update
        state = update(grads, params, state, LR)
    return params, state


@pytest.mark.parametrize("name", sorted(_METHODS))
def test_fused_bit_equal_to_per_leaf(name):
    params, state = _port(name, fused=False)
    fparams, fstate = _port(name, fused=True)
    for a, b in zip(params + _flat(state), fparams + _flat(fstate)):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(_METHODS))
def test_fused_matches_reference_fused(name):
    method = _METHODS[name](jopt)
    params = [jnp.asarray(a) for a in _arrays(0)]
    state = method.init_state(params)
    for i in range(3):
        grads = [jnp.asarray(a) for a in _arrays(i + 1)]
        params, state = method.update_fused(grads, params, state, LR)
    got, _ = _port(name, fused=True)
    for t, r in zip(got, params):
        r = np.asarray(r)
        err = float(np.abs(t.numpy() - r).max())
        assert err <= REF_RTOL * max(1.0, float(np.abs(r).max())), err


def test_lbfgs_opts_out():
    assert not LBFGS().supports_fused and not EMA(LBFGS()).supports_fused
    assert SGD().supports_fused and EMA(Adam()).supports_fused
    method = LBFGS(0.1)
    out = []
    for fused in (False, True):
        params = [torch.from_numpy(a) for a in _arrays(0)]
        state = method.init_state(params)
        update = method.update_fused if fused else method.update
        for i in range(3):
            state = update([torch.from_numpy(a) for a in _arrays(i + 1)],
                           params, state, 1.0)
        out.append(params)
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_layout_matches_reference():
    """One group per dtype in first-seen order; a scalar step counter
    never matches a one-leaf model's layout."""
    dts = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
           (torch.float32, jnp.float32), (torch.float16, jnp.float16),
           (torch.bfloat16, jnp.bfloat16)]
    shapes = [(3, 4), (5,), (2,), (4, 4), (1,)]
    tl = plan([torch.zeros(s, dtype=t) for s, (t, _) in zip(shapes, dts)])
    jl = jfused.plan([jnp.zeros(s, j) for s, (_, j) in zip(shapes, dts)])
    assert tl.groups == jl.groups == ((0, 2), (1, 4), (3,))
    one = FusedLayout([torch.zeros(4)])
    assert not jfused.FusedLayout(jnp.zeros(4)).matches(jnp.int32(3))
    assert not one.matches(np.int32(3))
    assert not one.matches([torch.ones(())])
    assert one.matches([torch.ones(4)])


def test_fuse_takes_back_to_back_tensors_as_they_are():
    flat = torch.arange(10.0)
    views = [flat[:4].view(2, 2), flat[4:].view(3, 2)]
    layout = plan(views)
    (buf,) = fuse(layout, views)
    assert buf.data_ptr() == flat.data_ptr() and torch.equal(buf, flat)
    apart = [torch.zeros(2, 2), torch.ones(3, 2)]
    (cat,) = fuse(layout, apart)
    assert cat.data_ptr() not in (apart[0].data_ptr(), apart[1].data_ptr())
    back = unfuse(layout, [cat])
    assert all(torch.equal(a, b) for a, b in zip(back, apart))
    assert all(b.data_ptr() >= cat.data_ptr() for b in back)


def _train(monkeypatch, fused):
    monkeypatch.setenv("BIGDL_TORCH_FUSED_UPDATE", "1" if fused else "0")
    x, y = _data(16)
    model = _small_resnet(tresnet, tnn, True).build(
        "cpu", torch.Generator().manual_seed(1))
    losses = {}

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > 3
    Optimizer(model, DataSet.array([Sample.from_ndarray(x[i], y[i])
                                    for i in range(16)]),
              tnn.CrossEntropyCriterion(), batch_size=8, device="cpu") \
        .set_optim_method(EMA(Adam(1e-2), 0.9)) \
        .set_end_when(Trigger(end, "steps")).optimize()
    return losses, list(model.parameters())


def test_optimizer_knob_trains_bit_equal(monkeypatch):
    base, fused = _train(monkeypatch, False), _train(monkeypatch, True)
    assert base[0] == fused[0]
    assert all(torch.equal(a, b) for a, b in zip(base[1], fused[1]))
