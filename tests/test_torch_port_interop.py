"""The port's Caffe, TensorFlow and Torch7 interop against the JAX package.

The cases of ``tests/test_interop.py``, each on the port: a model built
from a seeded generator on the CPU goes through the port's saver and
loader (``device="cpu"``) and forwards as before, within the reference
test's tolerance (1e-5 for the MLP and the Torch7 MLP, 1e-4 for the
convolutional ones, 1e-3 for the whole ResNet-20 and Inception, which
stay ``slow`` as the reference's do).  The cases that need a real
``tensorflow`` or a Torch7 reader skip without one, as the reference's.

Beside them, the port is held to the JAX package: LeNet-5 and a conv net
with BN+Scale and a ConcatTable residual block get the reference's built
weights (``load_reference_tree``) and are saved by both packages in every
format the reference writes for them (BigDL, Caffe with the same
``net_name``, and for the chain LeNet-5 also TF and Torch7); the files are
byte-identical, each package loads the other's, and the eval forwards of
one numpy batch agree within 1e-5 (float32).  ``model_validator`` counts
on every format what ``Evaluator`` counts on the source model, and its
CLI runs on the CPU only when asked to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_torch.nn as nn
import bigdl_tpu.interop as ref_interop
import bigdl_tpu.nn as rnn
from bigdl_torch.interop import (load_caffe, load_t7, load_tf, save_caffe,
                                 save_t7, save_tf)
from bigdl_torch.utils.convert import load_reference_tree


def _t(x):
    if isinstance(x, (list, tuple)):
        return [_t(v) for v in x]
    return torch.from_numpy(np.asarray(x, np.float32))


def _forward(model, x):
    model.eval()
    with torch.no_grad():
        return model(_t(x)).numpy()


def _rng(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _built(model, seed):
    return model.build("cpu", torch.Generator().manual_seed(seed))


@pytest.fixture
def mlp():
    return _built(nn.Sequential()
                  .add(nn.Linear(12, 20))
                  .add(nn.ReLU())
                  .add(nn.Linear(20, 5))
                  .add(nn.SoftMax()), 0)


@pytest.fixture
def convnet():
    return _built(nn.Sequential()
                  .add(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1))
                  .add(nn.ReLU())
                  .add(nn.SpatialMaxPooling(2, 2))
                  .add(nn.SpatialConvolution(8, 4, 3, 3)), 1)


def _train_forward(model, x):
    """One training forward: BatchNorm's running statistics move off
    their initial values, so a round trip carries them."""
    model.train()
    with torch.no_grad():
        model(_t(x))


# ------------------------------------------------------------------- caffe

def test_caffe_mlp_roundtrip(tmp_path, mlp):
    path = str(tmp_path / "mlp.caffemodel")
    save_caffe(mlp, None, path)
    loaded, _ = load_caffe(path, device="cpu")
    x = _rng(0, (4, 12))
    np.testing.assert_allclose(_forward(loaded, x), _forward(mlp, x),
                               rtol=1e-5, atol=1e-5)


def test_caffe_convnet_roundtrip(tmp_path, convnet):
    path = str(tmp_path / "conv.caffemodel")
    save_caffe(convnet, None, path)
    loaded, _ = load_caffe(path, device="cpu")
    x = _rng(1, (2, 8, 8, 3))
    np.testing.assert_allclose(_forward(loaded, x), _forward(convnet, x),
                               rtol=1e-4, atol=1e-4)


def test_caffe_shape_mismatch_raises(tmp_path, mlp):
    path = str(tmp_path / "bad.caffemodel")
    save_caffe(mlp, None, path)
    # a bias blob whose size disagrees with the layer fails loud
    # (reference: CaffeLoader.copyParameters raises on mismatch)
    from bigdl_torch.interop.caffe import CaffeLoader
    loader = CaffeLoader(path)
    loader.layers[0].blobs[1] = loader.layers[0].blobs[1][:7]
    with pytest.raises(ValueError):
        loader.build("cpu")


# ---------------------------------------------------------------------- tf

def test_tf_mlp_roundtrip(tmp_path, mlp):
    path = str(tmp_path / "mlp.pb")
    save_tf(mlp, None, path)
    loaded, _ = load_tf(path, device="cpu")
    x = _rng(2, (4, 12))
    np.testing.assert_allclose(_forward(loaded, x), _forward(mlp, x),
                               rtol=1e-5, atol=1e-5)


def test_tf_conv_same_padding_roundtrip(tmp_path):
    m = _built(nn.Sequential()
               .add(nn.SpatialConvolution(3, 6, 3, 3, 1, 1, -1, -1))  # SAME
               .add(nn.ReLU()), 3)
    path = str(tmp_path / "conv.pb")
    save_tf(m, None, path)
    loaded, _ = load_tf(path, device="cpu")
    x = _rng(3, (2, 7, 7, 3))
    ref = _forward(m, x)
    assert ref.shape == (2, 7, 7, 6)
    np.testing.assert_allclose(_forward(loaded, x), ref, rtol=1e-4,
                               atol=1e-4)


def test_tf_conv_reshape_linear_roundtrip(tmp_path):
    # conv (explicit symmetric padding -> SAME), pool, flatten, linear:
    # the LeNet-like shape chain with fused BiasAdds referenced downstream
    m = _built(nn.Sequential()
               .add(nn.SpatialConvolution(2, 8, 3, 3, 1, 1, 1, 1))
               .add(nn.ReLU())
               .add(nn.SpatialMaxPooling(2, 2))
               .add(nn.Reshape((8 * 3 * 3,)))
               .add(nn.Linear(72, 4)), 5)
    path = str(tmp_path / "lenetish.pb")
    save_tf(m, None, path)
    loaded, _ = load_tf(path, device="cpu")
    x = _rng(8, (3, 6, 6, 2))
    np.testing.assert_allclose(_forward(loaded, x), _forward(m, x),
                               rtol=1e-4, atol=1e-4)


def test_tf_same_pool_roundtrip(tmp_path):
    # SAME-padded pooling survives the round trip (the loader maps SAME to
    # pad=-1; TF's AvgPool leaves the padding out of the divisor)
    m = _built(nn.Sequential()
               .add(nn.SpatialConvolution(2, 4, 3, 3, 1, 1, -1, -1))
               .add(nn.SpatialMaxPooling(3, 3, 2, 2, -1, -1))
               .add(nn.ReLU()), 9)
    path = str(tmp_path / "samepool.pb")
    save_tf(m, None, path)
    loaded, _ = load_tf(path, device="cpu")
    x = _rng(9, (2, 7, 7, 2))
    ref = _forward(m, x)
    assert ref.shape == (2, 4, 4, 4)  # ceil(7/2) = 4 (TF SAME)
    np.testing.assert_allclose(_forward(loaded, x), ref, rtol=1e-4,
                               atol=1e-4)


def test_loaded_module_backward_works(tmp_path, mlp):
    # a loaded model's stateful facade (forward/backward/get_parameters)
    p = str(tmp_path / "m.bigdl")
    mlp.save(p)
    loaded = nn.Module.load(p, device="cpu")
    x = torch.ones((2, 12))
    out = loaded.update_output(x)
    loaded.backward(x, torch.ones_like(out))
    ws, gs = loaded.get_parameters()
    assert len(ws) == len(gs) > 0


def test_tf_save_rejects_unrepresentable_padding(tmp_path):
    m = _built(nn.Sequential().add(nn.SpatialConvolution(2, 4, 3, 3, 2, 2,
                                                         1, 1)), 6)
    with pytest.raises(ValueError):
        save_tf(m, None, str(tmp_path / "bad.pb"))


def test_tf_graphdef_parsed_by_real_tensorflow_if_available(tmp_path, mlp):
    # with tensorflow installed, real TF parses the GraphDef bytes
    tf = pytest.importorskip("tensorflow")
    path = str(tmp_path / "x.pb")
    save_tf(mlp, None, path)
    gd = tf.compat.v1.GraphDef()
    gd.ParseFromString(open(path, "rb").read())
    ops = [n.op for n in gd.node]
    assert "MatMul" in ops and "Softmax" in ops


# ---------------------------------------------------------------------- t7

def test_t7_scalar_table_roundtrip(tmp_path):
    obj = {"lr": 0.5, "name": "sgd", "nested": {"flag": True, "none": None},
           "arr": [1, 2, 3]}
    p = str(tmp_path / "o.t7")
    save_t7(obj, p)
    got = load_t7(p)
    assert got["lr"] == 0.5
    assert got["name"] == "sgd"
    assert got["nested"]["flag"] is True
    assert got["nested"]["none"] is None
    # contiguous 1..n integer keys come back as a Python list (Lua array)
    assert got["arr"] == [1, 2, 3]


def test_t7_tensor_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    for dtype in (np.float32, np.float64, np.int32, np.int64):
        arr = (rng.standard_normal((3, 4, 5)) * 10).astype(dtype)
        p = str(tmp_path / f"{np.dtype(dtype).name}.t7")
        save_t7(arr, p)
        got = load_t7(p)
        np.testing.assert_array_equal(got, arr)
        assert got.dtype == arr.dtype


def test_t7_params_tree_roundtrip(tmp_path, mlp):
    from bigdl_torch.utils.convert import to_reference_tree
    params, _ = to_reference_tree(mlp)
    p = str(tmp_path / "params.t7")
    save_t7(params, p)
    got = load_t7(p)
    for orig, back in zip(params, got):
        for k in orig:
            np.testing.assert_allclose(back[k], orig[k])


def test_torch_module_roundtrip(tmp_path, mlp):
    from bigdl_torch.interop import load_torch_module, save_torch_module
    p = str(tmp_path / "model.t7")
    save_torch_module(mlp, None, p)
    loaded, _ = load_torch_module(p, device="cpu")
    x = _rng(5, (4, 12))
    np.testing.assert_allclose(_forward(loaded, x), _forward(mlp, x),
                               rtol=1e-5, atol=1e-5)


def test_torch_module_conv_roundtrip(tmp_path, convnet):
    from bigdl_torch.interop import load_torch_module, save_torch_module
    p = str(tmp_path / "conv.t7")
    save_torch_module(convnet, None, p)
    loaded, _ = load_torch_module(p, device="cpu")
    x = _rng(6, (2, 8, 8, 3))
    np.testing.assert_allclose(_forward(loaded, x), _forward(convnet, x),
                               rtol=1e-4, atol=1e-4)


def test_native_module_save_load(tmp_path, mlp):
    p = str(tmp_path / "model.bigdl")
    mlp.save(p)
    loaded = type(mlp).load(p, device="cpu")
    x = _rng(7, (4, 12))
    np.testing.assert_allclose(_forward(loaded, x), _forward(mlp, x),
                               rtol=1e-6)
    # the saved model keeps its weights
    assert mlp.built and len(list(mlp.parameters())) == 4


def test_t7_read_by_torch_if_available(tmp_path):
    torchfile_mod = pytest.importorskip("torchfile")
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "x.t7")
    save_t7({"w": arr, "n": 3}, p)
    got = torchfile_mod.load(p)
    np.testing.assert_array_equal(got[b"w"], arr)
    assert got[b"n"] == 3


# ------------------------------------------------------------ caffe depth

def test_caffe_fc_layout_semantics():
    """The FC column permutation matches caffe: caffe flattens NCHW
    (C,H,W), the port NHWC (H,W,C); W_caffe on a CHW-flat vector equals
    the permuted weight on the HWC-flat vector."""
    from bigdl_torch.interop.caffe import (_fc_cols_chw_to_hwc,
                                           _fc_cols_hwc_to_chw)
    rng = np.random.default_rng(0)
    C, H, W, out = 3, 4, 5, 7
    x = rng.standard_normal((C, H, W)).astype(np.float32)
    w_caffe = rng.standard_normal((out, C * H * W)).astype(np.float32)
    y_caffe = w_caffe @ x.reshape(-1)                      # CHW flatten
    w_ours = _fc_cols_chw_to_hwc(w_caffe, C)
    y_ours = w_ours @ x.transpose(1, 2, 0).reshape(-1)     # HWC flatten
    np.testing.assert_allclose(y_ours, y_caffe, rtol=1e-5)
    np.testing.assert_allclose(_fc_cols_hwc_to_chw(w_ours, C), w_caffe)


def test_caffe_lenet_roundtrip(tmp_path):
    """LeNet crosses a conv->Flatten->InnerProduct boundary with H*W > 1,
    so forward parity proves the FC layout permutation end to end."""
    from bigdl_torch.models import LeNet5
    m = _built(LeNet5(10), 4)
    path = str(tmp_path / "lenet.caffemodel")
    save_caffe(m, None, path)
    loaded, _ = load_caffe(path, device="cpu")
    x = _rng(4, (2, 28, 28, 1))
    np.testing.assert_allclose(_forward(loaded, x), _forward(m, x),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.slow  # full-model caffe roundtrip: slow lane
def test_caffe_resnet_roundtrip(tmp_path):
    """ResNet-20/CIFAR: BatchNorm+Scale fold, ConcatTable->Eltwise
    residual branches, type-A shortcut (Concat + Power-as-MulConstant),
    pooling."""
    from bigdl_torch.models import ResNet
    m = _built(ResNet(20, class_num=10, dataset="cifar10"), 5)
    x = _rng(5, (2, 32, 32, 3))
    _train_forward(m, x)
    path = str(tmp_path / "resnet20.caffemodel")
    save_caffe(m, None, path)
    loaded, _ = load_caffe(path, device="cpu")
    np.testing.assert_allclose(_forward(loaded, x), _forward(m, x),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.slow  # full-model caffe roundtrip: slow lane
def test_caffe_inception_roundtrip(tmp_path):
    """Inception-v1 (no aux): LRN, ceil-mode pooling, Concat towers,
    Dropout, global 7x7 avgpool + classifier."""
    from bigdl_torch.models import Inception_v1_NoAuxClassifier
    m = _built(Inception_v1_NoAuxClassifier(10), 7)
    path = str(tmp_path / "inception.caffemodel")
    save_caffe(m, None, path)
    loaded, _ = load_caffe(path, device="cpu")
    x = _rng(7, (1, 224, 224, 3))
    np.testing.assert_allclose(_forward(loaded, x), _forward(m, x),
                               rtol=1e-3, atol=1e-3)


def test_caffe_deconv_eltwise_max_roundtrip(tmp_path):
    m = _built(nn.Sequential()
               .add(nn.SpatialFullConvolution(3, 6, 3, 3, 2, 2, 1, 1))
               .add(nn.ReLU())
               .add(nn.ConcatTable()
                    .add(nn.SpatialConvolution(6, 4, 1, 1))
                    .add(nn.SpatialConvolution(6, 4, 1, 1)))
               .add(nn.CMaxTable()), 8)
    path = str(tmp_path / "deconv.caffemodel")
    save_caffe(m, None, path)
    loaded, _ = load_caffe(path, device="cpu")
    x = _rng(8, (2, 6, 6, 3))
    np.testing.assert_allclose(_forward(loaded, x), _forward(m, x),
                               rtol=1e-4, atol=1e-4)


def test_caffe_standalone_scale_power(tmp_path):
    m = _built(nn.Sequential()
               .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1))
               .add(nn.Scale((4,)))
               .add(nn.Power(2.0, 0.5, 1.0)), 9)
    path = str(tmp_path / "scale.caffemodel")
    save_caffe(m, None, path)
    loaded, _ = load_caffe(path, device="cpu")
    x = _rng(9, (2, 5, 5, 3))
    np.testing.assert_allclose(_forward(loaded, x), _forward(m, x),
                               rtol=1e-4, atol=1e-4)


def test_caffe_unsupported_raises_unless_permissive(tmp_path, mlp):
    path = str(tmp_path / "unk.caffemodel")
    save_caffe(mlp, None, path)
    from bigdl_torch.interop.caffe import CaffeLoader
    loader = CaffeLoader(path)
    loader.layers[0].type = "MVN"  # a type the loader does not convert
    with pytest.raises(ValueError):
        loader.build("cpu")
    loader2 = CaffeLoader(path, permissive=True)
    loader2.layers[0].type = "MVN"
    loader2.build("cpu")  # maps to Identity with a warning


def test_torch_lenet_roundtrip(tmp_path):
    """LeNet through the .t7 codec: the NCHW (C,H,W) <-> NHWC (H,W,C)
    FC-column permutation and the 3-D reshape transposition."""
    from bigdl_torch.interop.torchfile import (load_torch_module,
                                               save_torch_module)
    from bigdl_torch.models import LeNet5
    m = _built(LeNet5(10), 10)
    path = str(tmp_path / "lenet.t7")
    save_torch_module(m, None, path)
    loaded, _ = load_torch_module(path, device="cpu")
    x = _rng(10, (2, 28, 28, 1))
    np.testing.assert_allclose(_forward(loaded, x), _forward(m, x),
                               rtol=1e-4, atol=1e-4)


def test_caffe_load_then_save_roundtrip(tmp_path):
    """load_caffe returns a Graph; persisting that Graph again works
    (load -> modify -> save, the reference CaffePersister use case)."""
    from bigdl_torch.models import LeNet5
    m = _built(LeNet5(10), 11)
    p1 = str(tmp_path / "l1.caffemodel")
    save_caffe(m, None, p1)
    g, gp = load_caffe(p1, device="cpu")
    p2 = str(tmp_path / "l2.caffemodel")
    save_caffe(g, gp, p2)
    g2, _ = load_caffe(p2, device="cpu")
    x = _rng(11, (2, 28, 28, 1))
    np.testing.assert_allclose(_forward(g2, x), _forward(m, x),
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- tf depth

def test_tf_batchnorm_roundtrip(tmp_path):
    """FusedBatchNormV3 save/load with running stats."""
    m = _built(nn.Sequential()
               .add(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, -1, -1))
               .add(nn.SpatialBatchNormalization(8))
               .add(nn.ReLU()), 12)
    x = _rng(12, (2, 8, 8, 3))
    _train_forward(m, x)
    path = str(tmp_path / "bn.pb")
    save_tf(m, None, path)
    loaded, _ = load_tf(path, device="cpu")
    np.testing.assert_allclose(_forward(loaded, x), _forward(m, x),
                               rtol=1e-4, atol=1e-4)


def _tf_wire():
    from bigdl_torch.interop.tensorflow import _const_node, _node_def
    from bigdl_torch.utils import pbwire
    return _const_node, _node_def, pbwire


def test_tf_decomposed_bn_const_folding(tmp_path):
    """A frozen decomposed BatchNorm (Mul/Add over Rsqrt(var+eps) const
    arithmetic) imports through constant folding and matches numpy."""
    _const_node, _node_def, pbwire = _tf_wire()
    rng = np.random.default_rng(13)
    c = 5
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    var = np.abs(rng.standard_normal(c)).astype(np.float32) + 0.5
    eps = np.float32(1e-3)
    out = bytearray()
    out += _node_def("input", "Placeholder", [],
                     {"dtype": pbwire.field_varint(6, 1)})
    out += _const_node("var", var)
    out += _const_node("eps", np.array([eps], np.float32))
    out += _const_node("gamma", gamma)
    out += _const_node("beta", beta)
    out += _const_node("mean", mean)
    out += _node_def("add_eps", "Add", ["var", "eps"])
    out += _node_def("rsqrt", "Rsqrt", ["add_eps"])
    out += _node_def("scale", "Mul", ["rsqrt", "gamma"])
    out += _node_def("scaled", "Mul", ["input", "scale"])
    out += _node_def("mean_scale", "Mul", ["mean", "scale"])
    out += _node_def("offset", "Sub", ["beta", "mean_scale"])
    out += _node_def("output", "Add", ["scaled", "offset"])
    path = str(tmp_path / "dbn.pb")
    with open(path, "wb") as f:
        f.write(out)
    loaded, _ = load_tf(path, device="cpu")
    x = rng.standard_normal((2, 4, 4, c)).astype(np.float32)
    scale = gamma / np.sqrt(var + eps)
    want = x * scale + (beta - mean * scale)
    np.testing.assert_allclose(_forward(loaded, x), want, rtol=1e-4,
                               atol=1e-5)


def test_tf_concat_axis(tmp_path):
    """ConcatV2 honors its axis input."""
    _const_node, _node_def, pbwire = _tf_wire()
    out = bytearray()
    out += _node_def("input", "Placeholder", [],
                     {"dtype": pbwire.field_varint(6, 1)})
    out += _node_def("r", "Relu", ["input"])
    out += _const_node("axis", np.array(1, np.int32), 3)
    out += _node_def("cat", "ConcatV2", ["input", "r", "axis"],
                     {"N": pbwire.field_varint(3, 2)})
    path = str(tmp_path / "cat.pb")
    with open(path, "wb") as f:
        f.write(out)
    loaded, _ = load_tf(path, device="cpu")
    x = _rng(14, (2, 3, 4, 5))
    want = np.concatenate([x, np.maximum(x, 0)], axis=1)  # height concat
    np.testing.assert_allclose(_forward(loaded, x), want, rtol=1e-6)


def _lstm_graph(n_in, n_hid, seed):
    _const_node, _node_def, pbwire = _tf_wire()
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((n_in + n_hid, 4 * n_hid)).astype(np.float32)
    bias = rng.standard_normal(4 * n_hid).astype(np.float32)
    out = bytearray()
    for name in ("x", "h", "c"):
        out += _node_def(name, "Placeholder", [],
                         {"dtype": pbwire.field_varint(6, 1)})
    out += _const_node("axis1", np.array(1, np.int32), 3)
    out += _node_def("xh", "ConcatV2", ["x", "h", "axis1"],
                     {"N": pbwire.field_varint(3, 2)})
    out += _const_node("W", W)
    out += _const_node("bvec", bias)
    out += _node_def("gates0", "MatMul", ["xh", "W"])
    out += _node_def("gates", "BiasAdd", ["gates0", "bvec"])
    out += _const_node("axis_s", np.array(1, np.int32), 3)
    out += _node_def("split", "Split", ["axis_s", "gates"],
                     {"num_split": pbwire.field_varint(3, 4)})
    # TF BasicLSTMCell order: i, j (candidate), f, o
    out += _node_def("ig", "Sigmoid", ["split:0"])
    out += _node_def("jg", "Tanh", ["split:1"])
    out += _node_def("fg", "Sigmoid", ["split:2"])
    out += _node_def("og", "Sigmoid", ["split:3"])
    out += _node_def("fc", "Mul", ["fg", "c"])
    out += _node_def("ij", "Mul", ["ig", "jg"])
    out += _node_def("c_new", "Add", ["fc", "ij"])
    out += _node_def("c_act", "Tanh", ["c_new"])
    out += _node_def("h_new", "Mul", ["og", "c_act"])
    return bytes(out), W, bias


def test_tf_unrolled_lstm_cell_import(tmp_path):
    """A BasicLSTMCell-style op graph (ConcatV2/MatMul/BiasAdd/Split/
    Sigmoid/Tanh/Mul/Add) imports as raw ops and computes an LSTM step."""
    n_in, n_hid, b = 3, 4, 2
    raw, W, bias = _lstm_graph(n_in, n_hid, 15)
    rng = np.random.default_rng(16)
    x = rng.standard_normal((b, n_in)).astype(np.float32)
    h = rng.standard_normal((b, n_hid)).astype(np.float32)
    c = rng.standard_normal((b, n_hid)).astype(np.float32)
    path = str(tmp_path / "lstm.pb")
    with open(path, "wb") as f:
        f.write(raw)
    loaded, _ = load_tf(path, outputs="h_new", device="cpu")
    got = _forward(loaded, [x, h, c])

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))
    gates = np.concatenate([x, h], 1) @ W + bias
    i_, j_, f_, o_ = np.split(gates, 4, axis=1)
    c_new = sig(f_) * c + sig(i_) * np.tanh(j_)
    want = sig(o_) * np.tanh(c_new)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_tf_unsupported_raises_unless_permissive(tmp_path):
    _const_node, _node_def, pbwire = _tf_wire()
    out = bytearray()
    out += _node_def("input", "Placeholder", [],
                     {"dtype": pbwire.field_varint(6, 1)})
    out += _node_def("w", "WeirdOp", ["input"])
    path = str(tmp_path / "weird.pb")
    with open(path, "wb") as f:
        f.write(out)
    with pytest.raises(ValueError):
        load_tf(path, device="cpu")
    load_tf(path, permissive=True, device="cpu")


def test_tf_saved_graph_executes_in_real_tensorflow(tmp_path):
    """Real TensorFlow executes the port's GraphDef with numeric parity
    (the reference's saved graphs run under TF,
    utils/tf/TensorflowSaver.scala)."""
    tf = pytest.importorskip("tensorflow")
    m = _built(nn.Sequential()
               .add(nn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1))
               .add(nn.ReLU())
               .add(nn.SpatialMaxPooling(2, 2, 2, 2))
               .add(nn.Reshape((4 * 4 * 4,)))
               .add(nn.Linear(4 * 4 * 4, 5))
               .add(nn.SoftMax()), 11)
    x = _rng(11, (2, 8, 8, 2))
    ref = _forward(m, x)
    path = str(tmp_path / "convnet.pb")
    save_tf(m, None, path)

    gd = tf.compat.v1.GraphDef()
    gd.ParseFromString(open(path, "rb").read())
    g = tf.Graph()
    with g.as_default():
        tf.import_graph_def(gd, name="")
        inp = g.get_tensor_by_name("input:0")
        # the last op's first output is the model head (topological order)
        out_t = g.get_operations()[-1].outputs[0]
        with tf.compat.v1.Session(graph=g) as sess:
            got = sess.run(out_t, {inp: x})
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


# ------------------------------------------------- the port vs the JAX package

def _lenet(pkg):
    if pkg is nn:
        from bigdl_torch.models import LeNet5
    else:
        from bigdl_tpu.models.lenet import LeNet5
    return LeNet5(10)


def _bn_residual(pkg):
    """Conv + BN (Caffe's BatchNorm + Scale), a ConcatTable residual block
    (Eltwise), pooling and a classifier."""
    branch = (pkg.Sequential()
              .add(pkg.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1))
              .add(pkg.SpatialBatchNormalization(8))
              .add(pkg.ReLU())
              .add(pkg.SpatialConvolution(8, 8, 1, 1))
              .add(pkg.SpatialBatchNormalization(8)))
    return (pkg.Sequential()
            .add(pkg.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1))
            .add(pkg.SpatialBatchNormalization(8))
            .add(pkg.ReLU())
            .add(pkg.ConcatTable().add(branch).add(pkg.Identity()))
            .add(pkg.CAddTable())
            .add(pkg.ReLU())
            .add(pkg.SpatialMaxPooling(2, 2, 2, 2))
            .add(pkg.Reshape((4 * 4 * 8,)))
            .add(pkg.Linear(4 * 4 * 8, 5)))


MODELS = {"lenet": (_lenet, (2, 28, 28, 1)),
          "bn_residual": (_bn_residual, (2, 8, 8, 3))}

#: (model, format): every format the reference's savers write the model in
#: (TF and Torch7 hold chains only)
CASES = [("lenet", f) for f in ("bigdl", "caffe", "tf", "t7")] + \
        [("bn_residual", f) for f in ("bigdl", "caffe")]


def _pair(name, seed=21):
    """The reference's model built from a key, its BatchNorm statistics
    moved off their initial values, and the port's copy of it."""
    make, shape = MODELS[name]
    ref = make(rnn)
    ref.build(jax.random.key(seed))
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    state = jax.tree_util.tree_map(np.asarray, ref.state)
    rng = np.random.default_rng(seed)

    def moved(tree):
        if isinstance(tree, list):
            return [moved(t) for t in tree]
        out = dict(tree)
        if "running_mean" in out:
            c = out["running_mean"].shape
            out["running_mean"] = rng.standard_normal(c).astype(np.float32)
            out["running_var"] = (rng.random(c) + 0.5).astype(np.float32)
        return out
    state = moved(state)
    ref.attach(jax.tree_util.tree_map(jnp.asarray, params),
               jax.tree_util.tree_map(jnp.asarray, state))
    port = make(nn).build("cpu")
    load_reference_tree(port, params, state)
    return ref, port, _rng(seed, shape)


def _save(pkg, fmt, model, path):
    if pkg == "ref":
        if fmt == "bigdl":
            from bigdl_tpu.interop import bigdl as fmt_mod
            return fmt_mod.save(model, path)
        if fmt == "caffe":
            return ref_interop.CaffePersister.save(
                model, model.params, path, net_name="interop",
                state=model.state)
        if fmt == "tf":
            return ref_interop.save_tf(model, model.params, path,
                                       state=model.state)
        return ref_interop.save_torch_module(model, model.params, path)
    from bigdl_torch import interop
    if fmt == "bigdl":
        return interop.save_bigdl(model, path)
    if fmt == "caffe":
        return interop.CaffePersister.save(model, None, path,
                                           net_name="interop")
    if fmt == "tf":
        return interop.save_tf(model, None, path)
    return interop.save_torch_module(model, None, path)


def _load(pkg, fmt, path):
    """The loaded model and its eval forward."""
    if pkg == "ref":
        if fmt == "bigdl":
            from bigdl_tpu.interop import bigdl as fmt_mod
            m = fmt_mod.load(path)
        else:
            loader = {"caffe": ref_interop.load_caffe,
                      "tf": ref_interop.load_tf,
                      "t7": ref_interop.load_torch_module}[fmt]
            m = loader(path)[0]

        def fwd(x):
            out, _ = m.apply(m.params, m.state, jnp.asarray(x),
                             training=False)
            return np.asarray(out)
        return m, fwd
    from bigdl_torch import interop
    if fmt == "bigdl":
        m = interop.load_bigdl(path, device="cpu")
    else:
        loader = {"caffe": interop.load_caffe, "tf": interop.load_tf,
                  "t7": interop.load_torch_module}[fmt]
        m = loader(path, device="cpu")[0]
    return m, lambda x: _forward(m, x)


@pytest.mark.parametrize("name,fmt", CASES)
def test_savers_write_the_reference_bytes(tmp_path, name, fmt):
    ref, port, _ = _pair(name)
    _save("ref", fmt, ref, str(tmp_path / "ref"))
    _save("port", fmt, port, str(tmp_path / "port"))
    a = (tmp_path / "ref").read_bytes()
    b = (tmp_path / "port").read_bytes()
    assert len(a) > 1000 and a == b


@pytest.mark.parametrize("name,fmt", CASES)
def test_each_package_loads_the_others_files(tmp_path, name, fmt):
    ref, port, x = _pair(name)
    want, _ = ref.apply(ref.params, ref.state, jnp.asarray(x),
                        training=False)
    want = np.asarray(want)
    np.testing.assert_allclose(_forward(port, x), want, rtol=1e-5,
                               atol=1e-5)
    _save("ref", fmt, ref, str(tmp_path / "ref"))
    _save("port", fmt, port, str(tmp_path / "port"))
    _, port_fwd = _load("port", fmt, str(tmp_path / "ref"))
    _, ref_fwd = _load("ref", fmt, str(tmp_path / "port"))
    np.testing.assert_allclose(port_fwd(x), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref_fwd(x), want, rtol=1e-5, atol=1e-5)


def test_module_savers_write_what_the_functions_write(tmp_path):
    """``Module.save_caffe`` (both forms), ``save_tf`` and ``save_torch``
    write the files the module-level savers write."""
    from bigdl_torch.interop import save_torch_module
    _, port, _ = _pair("lenet")
    port.save_caffe(str(tmp_path / "a.caffemodel"))
    port.save_caffe(str(tmp_path / "b.prototxt"),
                    str(tmp_path / "b.caffemodel"))
    save_caffe(port, None, str(tmp_path / "c.caffemodel"))
    assert (tmp_path / "a.caffemodel").read_bytes() == \
        (tmp_path / "c.caffemodel").read_bytes() == \
        (tmp_path / "b.caffemodel").read_bytes()
    text = (tmp_path / "b.prototxt").read_text()
    assert text.startswith('name: "bigdl_torch"') and "InnerProduct" in text
    port.save_tf(str(tmp_path / "a.pb"))
    save_tf(port, None, str(tmp_path / "c.pb"))
    assert (tmp_path / "a.pb").read_bytes() == (tmp_path / "c.pb").read_bytes()
    port.save_torch(str(tmp_path / "a.t7"))
    save_torch_module(port, None, str(tmp_path / "c.t7"))
    assert (tmp_path / "a.t7").read_bytes() == (tmp_path / "c.t7").read_bytes()


def test_model_validator_counts_what_the_evaluator_counts(tmp_path,
                                                          monkeypatch):
    """``validate`` over BDRecord shards gives the Top-1 and Top-5 counts
    of ``Evaluator`` on the source model; its CLI refuses to run on the
    CPU unless ``--device cpu`` is given."""
    from bigdl_torch.dataset import DataSet
    from bigdl_torch.models.run import _load_samples
    from bigdl_torch.optim import Evaluator, Top1Accuracy, Top5Accuracy
    from bigdl_torch.tools import model_validator
    from bigdl_torch.utils.recordio import write_records
    _, port, _ = _pair("lenet")
    rng = np.random.default_rng(23)
    recs = [{"data": rng.integers(0, 256, (28, 28, 1)).astype(np.uint8),
             "label": float(rng.integers(1, 11))} for _ in range(40)]
    data = str(tmp_path / "val")
    write_records(data, recs)
    want = Evaluator(port, device="cpu").test(
        DataSet.array(_load_samples(data, None)),
        [Top1Accuracy(), Top5Accuracy()], batch_size=16)
    want = {m.name: r.result() for m, r in want}
    for fmt, path in (("bigdl", "m.bigdl"), ("caffe", "m.caffemodel"),
                      ("tf", "m.pb"), ("torch", "m.t7")):
        _save("port", {"torch": "t7"}.get(fmt, fmt), port,
              str(tmp_path / path))
        got = model_validator.validate(fmt, str(tmp_path / path), data,
                                       batch_size=16, device="cpu")
        assert {k: (v["accuracy"], v["count"]) for k, v in got.items()} \
            == want, fmt
    assert want["Top1Accuracy"][1] == 40
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--model-type", "bigdl", "--model", str(tmp_path / "m.bigdl"),
            "--data", data, "--batch-size", "16"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_validator.main(args)
    model_validator.main(args + ["--json", "--device", "cpu"])
