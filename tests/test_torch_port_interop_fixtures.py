"""The port's interop against the committed foreign bytes
(``tests/fixtures/interop/``).

The cases of ``tests/test_interop_fixtures.py`` on the port: the Caffe
model (from a standalone protobuf writer, with a numpy NCHW oracle), the
frozen GraphDef (written and run by real TensorFlow) and the Torch7 codec
file (a standalone writer) load on the CPU and meet their expected outputs
at the reference tests' tolerances (1e-4 relative, 1e-5 absolute).  Then
every committed fixture, the two BigDL streams included, loads in both
packages and the eval forwards of the same numpy input agree within 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "interop")


def _forward(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def test_caffe_fixture_loads_with_numeric_parity():
    """conv + BatchNorm (its scale_factor) + Scale fold + MaxPool + the FC
    layout permutation + Softmax, against the numpy NCHW oracle."""
    from bigdl_torch.interop.caffe import load_caffe
    blob = np.load(os.path.join(FIX, "lenet_bn_expected.npz"))
    model, _ = load_caffe(os.path.join(FIX, "lenet_bn.caffemodel"),
                          device="cpu")
    np.testing.assert_allclose(_forward(model, blob["input_nhwc"]),
                               blob["prob"], rtol=1e-4, atol=1e-5)


def test_tf_fixture_loads_with_numeric_parity():
    """A frozen GraphDef emitted by real tensorflow; the expected output
    from a real tf session."""
    from bigdl_torch.interop.tensorflow import load_tf
    blob = np.load(os.path.join(FIX, "convnet_expected.npz"))
    model, _ = load_tf(os.path.join(FIX, "convnet.pb"), inputs=["input"],
                       outputs="output", device="cpu")
    np.testing.assert_allclose(_forward(model, blob["input"]),
                               blob["output"], rtol=1e-4, atol=1e-5)


def test_t7_fixture_decodes():
    """Torch7 bytes from the independent writer: tensors (storages and
    strides), booleans, strings, numbers, nested tables."""
    from bigdl_torch.interop.torchfile import load_t7
    blob = np.load(os.path.join(FIX, "codec_t7_expected.npz"))
    obj = load_t7(os.path.join(FIX, "codec.t7"))
    np.testing.assert_array_equal(obj["weight"], blob["weight"])
    np.testing.assert_array_equal(obj["bias"], blob["bias"])
    assert obj["train"] is False
    assert obj["name"] == "fixture"
    assert obj["epoch"] == 3
    assert obj["nested"] == [10.5, "two"]  # 1..n keys -> list


def test_fixture_bytes_are_stable():
    """The committed bytes the port is held to have not drifted."""
    import hashlib
    digests = {}
    for name in ("lenet_bn.caffemodel", "codec.t7"):
        with open(os.path.join(FIX, name), "rb") as f:
            digests[name] = hashlib.sha256(f.read()).hexdigest()[:16]
    assert digests == {
        "lenet_bn.caffemodel": "683a1cba951e641b",
        "codec.t7": "8c52e35d0c99f718",
    }, digests


def _inputs(name):
    if name == "lenet_bn.caffemodel":
        return np.load(os.path.join(FIX, "lenet_bn_expected.npz"))[
            "input_nhwc"]
    if name == "convnet.pb":
        return np.load(os.path.join(FIX, "convnet_expected.npz"))["input"]
    shape = {"lenet_like.bigdl": (2, 28, 28, 1),
             "simple_rnn_canonical.bigdl": (2, 5, 6)}[name]
    return np.fromfile(os.path.join(FIX, name + ".x"),
                       dtype=np.float32).reshape(shape)


def _ref_forward(name, x):
    path = os.path.join(FIX, name)
    if name.endswith(".bigdl"):
        from bigdl_tpu.interop import bigdl as fmt
        m = fmt.load(path)
    elif name.endswith(".pb"):
        from bigdl_tpu.interop import load_tf
        m = load_tf(path, inputs=["input"], outputs="output")[0]
    else:
        from bigdl_tpu.interop import load_caffe
        m = load_caffe(path)[0]
    out, _ = m.apply(m.params, m.state, jnp.asarray(x), training=False)
    return np.asarray(out)


def _port_forward(name, x):
    from bigdl_torch import interop
    path = os.path.join(FIX, name)
    if name.endswith(".bigdl"):
        m = interop.load_bigdl(path, device="cpu")
    elif name.endswith(".pb"):
        m = interop.load_tf(path, inputs=["input"], outputs="output",
                            device="cpu")[0]
    else:
        m = interop.load_caffe(path, device="cpu")[0]
    return _forward(m, x)


@pytest.mark.parametrize("name", ["lenet_bn.caffemodel", "convnet.pb",
                                  "lenet_like.bigdl",
                                  "simple_rnn_canonical.bigdl"])
def test_fixture_loads_as_in_the_reference(name):
    x = _inputs(name)
    np.testing.assert_allclose(_port_forward(name, x), _ref_forward(name, x),
                               rtol=1e-5, atol=1e-5)


def test_t7_fixture_decodes_as_in_the_reference():
    from bigdl_torch.interop import load_t7
    from bigdl_tpu.interop import load_t7 as ref_load_t7
    path = os.path.join(FIX, "codec.t7")
    got, want = load_t7(path), ref_load_t7(path)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        else:
            assert got[k] == want[k]
