"""int8 weight quantization against the JAX package.

- ``quantize_array``: ``q`` (int8) and ``scale`` (float32) equal to the
  reference's bit for bit, on every channel axis the twins use (0, 1 and
  3), an all-zero channel (scale 1) and values that round half to even
  included.
- ``quantize`` of LeNet-5, a small ResNet (depth 8, cifar, its
  BatchNorms left float) and a small TransformerLM, each from the
  reference's float weights: the quantized trees equal the reference's
  quantized trees (``to_reference_tree``: every int8 value and scale
  exact, the rest equal) and the eval-mode forwards agree within 1e-5;
  the quantized LM's ``cached_generate`` tokens equal the reference's; a
  reference quantized tree loads back into the port's quantized model.
- The float model is untouched, an unbuilt one raises, the twins take no
  gradient and refuse ``build``; ``QuantLookupTable`` (one-based ids
  included) and a ``max_norm`` table left float as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu import quantization as jq
from bigdl_tpu.models import LeNet5 as JLeNet5
from bigdl_tpu.models import ResNet as JResNet
from bigdl_tpu.models import TransformerLM as JLM
from bigdl_tpu.models import decode as jdec

import bigdl_torch.nn as tnn
from bigdl_torch import quantization as tq
from bigdl_torch.models import LeNet5, ResNet, TransformerLM
from bigdl_torch.models import decode as tdec
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree
from torch_port_harness import build_pair, close, x

LM_CFG = dict(vocab_size=40, max_len=24, d_model=32, num_heads=2,
              num_layers=2)


@pytest.mark.parametrize("shape,axis", [((16, 32), 0), ((32, 24), 1),
                                        ((3, 3, 4, 8), 3), ((50, 6), 0)])
def test_quantize_array_equals_reference(shape, axis):
    w = np.random.RandomState(sum(shape)).standard_normal(shape).astype(
        np.float32)
    # a channel of zeros, and exact halves of a step
    idx = [slice(None)] * len(shape)
    idx[axis] = 0
    w[tuple(idx)] = 0.0
    idx[axis] = 1
    w[tuple(idx)] = np.linspace(-2.5, 2.5, w[tuple(idx)].size).reshape(
        w[tuple(idx)].shape)
    tqv, tsc = tq.quantize_array(torch.from_numpy(w), axis)
    jqv, jsc = jq.quantize_array(w, axis)
    assert tqv.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    assert float(tsc[0]) == 1.0
    assert tqv.abs().max() <= 127


def _trees_equal(tree, ref, path="root"):
    if isinstance(ref, dict):
        assert isinstance(tree, dict) and set(tree) == set(ref), (path,
                                                                  tree, ref)
        for k in ref:
            _trees_equal(tree[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(tree) == len(ref), path
        for i, (a, b) in enumerate(zip(tree, ref)):
            _trees_equal(a, b, f"{path}/{i}")
    else:
        a, b = np.asarray(tree), np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _quantized_pair(jm, tm):
    build_pair(jm, tm)
    jqm, tqm = jq.quantize(jm), tq.quantize(tm)
    tparams, tstate = to_reference_tree(tqm)
    _trees_equal(tparams, jax.tree.map(np.asarray, jqm.params))
    _trees_equal(tstate, jax.tree.map(np.asarray, jqm.state))
    return jqm, tqm


def _forward_close(jqm, tqm, xs):
    jy, _ = jqm.apply(jqm.params, jqm.state, jnp.asarray(xs),
                      training=False)
    with torch.inference_mode():
        ty = tqm.eval()(torch.from_numpy(np.asarray(xs)))
    close(ty, jy, what="quantized forward")


def test_quantized_lenet_matches_reference():
    jqm, tqm = _quantized_pair(JLeNet5(10), LeNet5(10))
    assert sum(isinstance(m, tq.QuantSpatialConvolution)
               for m in tqm.modules()) == 2
    assert sum(isinstance(m, tq.QuantLinear) for m in tqm.modules()) == 2
    _forward_close(jqm, tqm, x((4, 28, 28, 1)))


def test_quantized_resnet_matches_reference():
    jqm, tqm = _quantized_pair(
        JResNet(depth=8, class_num=10, dataset="cifar10"),
        ResNet(depth=8, class_num=10, dataset="cifar10"))
    assert any(isinstance(m, tnn.SpatialBatchNormalization)
               for m in tqm.modules())
    _forward_close(jqm, tqm, x((2, 32, 32, 3), seed=1))


def _lm_pair():
    return _quantized_pair(JLM(**LM_CFG), TransformerLM(**LM_CFG))


def test_quantized_lm_matches_reference():
    jqm, tqm = _lm_pair()
    mhas = [m for m in tqm.modules() if isinstance(m, tnn.MultiHeadAttention)]
    assert len(mhas) == 2 and all(isinstance(m, tq.QuantMultiHeadAttention)
                                  for m in mhas)
    assert any(isinstance(m, tq.QuantLookupTable) for m in tqm.modules())
    toks = np.random.RandomState(2).randint(0, 40, (3, 20)).astype(np.int32)
    _forward_close(jqm, tqm, toks)


@pytest.mark.parametrize("prompt", [[[3, 4, 5]], [[1, 2, 3, 4], [7, 8, 9,
                                                                 10]]])
def test_quantized_cached_generate_tokens_equal(prompt):
    jqm, tqm = _lm_pair()
    want = jdec.cached_generate(jqm, prompt, 6, max_len=LM_CFG["max_len"])
    with torch.inference_mode():
        got = tdec.cached_generate(tqm.eval(), prompt, 6,
                                   max_len=LM_CFG["max_len"])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_reference_quantized_tree_loads_into_port():
    jm = JLM(**LM_CFG).build(jax.random.key(3))
    jqm = jq.quantize(jm)
    tm = TransformerLM(**LM_CFG).build("cpu")
    tqm = tq.quantize(tm)
    load_reference_tree(tqm, jax.tree.map(np.asarray, jqm.params),
                        jax.tree.map(np.asarray, jqm.state))
    _trees_equal(to_reference_tree(tqm)[0],
                 jax.tree.map(np.asarray, jqm.params))
    toks = np.random.RandomState(5).randint(0, 40, (2, 9)).astype(np.int32)
    _forward_close(jqm, tqm, toks)


def test_float_model_untouched_and_rules():
    m = LeNet5(10).build("cpu")
    before = [p.detach().clone() for p in m.parameters()]
    qm = tq.quantize(m)
    for a, b in zip(before, m.parameters()):
        assert torch.equal(a, b)
    assert all(not p.requires_grad for p in qm.parameters())
    with pytest.raises(RuntimeError, match="cannot be"):
        qm.build("cpu")
    with pytest.raises(ValueError):
        tq.quantize(tnn.Linear(4, 4))


@pytest.mark.parametrize("one_based", [False, True])
def test_quant_lookup_table_matches_reference(one_based):
    jm, tm = build_pair(jnn.LookupTable(12, 5, one_based=one_based),
                        tnn.LookupTable(12, 5, one_based=one_based))
    jqm, tqm = jq.quantize(jm), tq.quantize(tm)
    assert isinstance(tqm, tq.QuantLookupTable)
    ids = np.random.RandomState(1).randint(int(one_based), 12, (3, 4))
    _forward_close(jqm, tqm, ids.astype(np.int32))
    renorm = tnn.LookupTable(12, 5, max_norm=1.0).build("cpu")
    assert type(tq.quantize(renorm)) is tnn.LookupTable
