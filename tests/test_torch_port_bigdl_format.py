"""The port's JVM BigDL format (Java object serialization) against the JAX
package.

The cases of ``tests/test_bigdl_format.py`` (the codec, round trips, the
frozen ``lenet_like.bigdl`` fixture and its golden output, the wire
layouts, fail-loud classes, ``model_validator``'s sniffing), of
``tests/test_wire_audit.py`` (every class descriptor the writer emits
against the reference's Scala source; they skip where that checkout is
absent, as the reference's do, and read it through that module) and
``tests/test_convbn.py::test_residual_tail_bigdl_format_defuses``, each on
the port: models built from a seeded generator on the CPU, loaded with
``device="cpu"``, forwards compared in eval mode at the reference tests'
tolerances (1e-5 relative, 1e-6 absolute; the golden output 1e-5).

Beside them, each of the wire audit's kitchen-sink models (a CNN with
every layer the format maps, the table plumbing, RnnCell, LSTM, GRU and
LSTMPeephole recurrences, the text front end, BinaryTreeLSTM, a Graph
DAG) gets the reference's built weights and is written by both
packages: the streams are byte-identical, and each package loads the
other's.
"""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_torch.nn as nn
import bigdl_tpu.nn as rnn
from bigdl_torch.interop import bigdl as bigdl_fmt
from bigdl_torch.interop.javaser import (JavaArray, JavaObject, JavaWriter,
                                         load_stream, loads)
from bigdl_torch.utils.convert import load_reference_tree

import test_wire_audit as wire_audit

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "interop",
                       "lenet_like.bigdl")


def _forward(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _built(model, seed=0):
    return model.build("cpu", torch.Generator().manual_seed(seed))


def _model():
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(1, 4, 5, 5))
    m.add(nn.SpatialBatchNormalization(4))
    m.add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
    m.add(nn.Reshape([12 * 12 * 4]))
    m.add(nn.Linear(12 * 12 * 4, 10))
    m.add(nn.LogSoftMax())
    return _built(m, 3)


def test_javaser_roundtrip_primitives():
    """The generic codec: write(read(x)) == x for a mixed object graph."""
    from bigdl_torch.interop.javaser import JavaClassDesc

    cd = JavaClassDesc("com.example.Foo", 42, 2,
                       [("I", "n", None), ("D", "x", None),
                        ("[", "arr", "[F"),
                        ("L", "name", "Ljava/lang/String;")], None)
    arr = JavaArray(JavaClassDesc("[F", 1, 2, [], None),
                    np.arange(5, dtype=np.float32))
    obj = JavaObject(cd, {"n": 7, "x": 2.5, "arr": arr, "name": "hello"})
    w = JavaWriter()
    w.write_object(obj)
    [back] = loads(w.getvalue())
    assert back.classname == "com.example.Foo"
    assert back.fields["n"] == 7 and back.fields["x"] == 2.5
    assert back.fields["name"] == "hello"
    np.testing.assert_array_equal(back.fields["arr"].values, arr.values)


def test_save_load_roundtrip(tmp_path):
    m = _model()
    x = _x(0, (2, 28, 28, 1))
    p = str(tmp_path / "model.bigdl")
    bigdl_fmt.save(m, p)
    loaded = bigdl_fmt.load(p, device="cpu")
    np.testing.assert_allclose(_forward(loaded, x), _forward(m, x),
                               rtol=1e-5, atol=1e-6)


def test_frozen_fixture_loads_and_predicts():
    """The checked-in fixture's bytes: stream magic, class names with the
    reference's SerialVersionUIDs, and a prediction that matches the
    recorded golden output."""
    with open(FIXTURE, "rb") as fh:
        raw = fh.read()
    assert struct.unpack(">HH", raw[:4]) == (0xACED, 5)
    assert b"com.intel.analytics.bigdl.nn.Sequential" in raw
    assert b"com.intel.analytics.bigdl.tensor.DenseTensor" in raw

    model = bigdl_fmt.load(FIXTURE, device="cpu")
    x = np.fromfile(FIXTURE + ".x", dtype=np.float32).reshape(2, 28, 28, 1)
    golden = np.fromfile(FIXTURE + ".y", dtype=np.float32).reshape(2, 10)
    np.testing.assert_allclose(_forward(model, x), golden, rtol=1e-5,
                               atol=1e-5)


def test_concat_branch_roundtrip(tmp_path):
    """Inception-style branched topology (Concat + nested Sequentials)
    survives the wire format."""
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(3, 8, 3, 3, pad_w=1, pad_h=1))
    c = nn.Concat(-1)
    b1 = nn.Sequential()
    b1.add(nn.SpatialConvolution(8, 4, 1, 1))
    b1.add(nn.ReLU())
    b2 = nn.Sequential()
    b2.add(nn.SpatialConvolution(8, 6, 3, 3, pad_w=1, pad_h=1))
    b2.add(nn.ReLU())
    c.add(b1)
    c.add(b2)
    m.add(c)
    m.add(nn.SpatialBatchNormalization(10))
    _built(m)
    x = _x(1, (2, 8, 8, 3))
    p = str(tmp_path / "branch.bigdl")
    bigdl_fmt.save(m, p)
    m2 = bigdl_fmt.load(p, device="cpu")
    np.testing.assert_allclose(_forward(m2, x), _forward(m, x), rtol=1e-5,
                               atol=1e-6)
    # the wire carries the reference's 1-based NCHW channel dim
    with open(p, "rb") as fh:
        contents = load_stream(fh)
    [root] = [c_ for c_ in contents if isinstance(c_, JavaObject)]
    concat = root.fields["modules"].fields["array"].values[1]
    assert concat.classname.endswith(".Concat")
    assert concat.fields["dimension"] == 2


def test_table_layers_roundtrip(tmp_path):
    """Residual-style table plumbing (ConcatTable/JoinTable/CAddTable with
    its inplace flag, SpatialZeroPadding) survives both directions."""
    m = nn.Sequential()
    m.add(nn.SpatialZeroPadding(1))
    m.add(nn.ConcatTable().add(nn.Identity()).add(nn.Identity()))
    m.add(nn.JoinTable(-1))
    m.add(nn.ConcatTable().add(nn.Identity()).add(nn.Identity()))
    m.add(nn.CAddTable(True))
    m.add(nn.Dropout(0.3))            # identity in eval mode
    m.add(nn.SpatialAveragePooling(2, 2, 2, 2))
    m.add(nn.SpatialCrossMapLRN(3, 0.5, 0.7, 1.5))
    m.add(nn.Threshold(0.1, -0.2))
    m.add(nn.Power(2.0, 1.5, 0.25))
    _built(m)
    x = _x(1, (2, 4, 4, 3))
    p = str(tmp_path / "tables.bigdl")
    bigdl_fmt.save(m, p)
    m2 = bigdl_fmt.load(p, device="cpu")
    np.testing.assert_allclose(_forward(m2, x), _forward(m, x))
    assert m2.layers[4].inplace is True  # wire fidelity, not hardcoded


def test_wire_layout_matches_reference():
    """The serialized Linear weight is (out, in) on the wire, the
    reference's nn/Linear.scala layout."""
    with open(FIXTURE, "rb") as fh:
        contents = load_stream(fh)
    [root] = [c for c in contents if isinstance(c, JavaObject)]

    def find(obj, cls):
        if isinstance(obj, JavaObject):
            if obj.classname.endswith(cls):
                yield obj
            for v in obj.fields.values():
                yield from find(v, cls)
        elif hasattr(obj, "values") and isinstance(obj.values, list):
            for v in obj.values:
                yield from find(v, cls)

    [linear] = find(root, ".Linear")
    size = np.asarray(linear.fields["weight"].fields["_size"].values)
    np.testing.assert_array_equal(size[:2], [10, 12 * 12 * 4])  # (out, in)
    [conv] = find(root, ".SpatialConvolution")
    csize = np.asarray(conv.fields["weight"].fields["_size"].values)
    np.testing.assert_array_equal(csize[:5], [1, 4, 1, 5, 5])


def test_unknown_layer_fails_loud(tmp_path):
    from bigdl_torch.interop.javaser import JavaClassDesc

    cd = JavaClassDesc("com.intel.analytics.bigdl.nn.RoiPooling",
                       1, 2, [], None)
    w = JavaWriter()
    w.write_object(JavaObject(cd, {}))
    p = tmp_path / "weird.bigdl"
    p.write_bytes(w.getvalue())
    with pytest.raises(ValueError, match="RoiPooling"):
        bigdl_fmt.load(str(p), device="cpu")


def test_model_validator_bigdl_format(tmp_path):
    """model_validator's bigdl type sniffs the JVM wire format and still
    reads the port's own module file."""
    from bigdl_torch.tools.model_validator import load_model

    m = _model()
    jvm = str(tmp_path / "m_jvm.bigdl")
    bigdl_fmt.save(m, jvm)
    ours = str(tmp_path / "m_ours.bigdl")
    m.save(ours)
    x = _x(1, (2, 28, 28, 1))
    want = _forward(m, x)
    for path in (jvm, ours):
        loaded = load_model("bigdl", path, device="cpu")
        np.testing.assert_allclose(_forward(loaded, x), want, rtol=1e-5,
                                   atol=1e-6, err_msg=path)


def test_javaser_fuzz_roundtrip():
    """Random object graphs (nested objects, shared refs, primitive
    arrays of every type, strings, nulls, class hierarchies with
    writeObject annotations) round-trip bit-exactly through the codec."""
    import random

    from bigdl_torch.interop.javaser import (_PRIM, SC_SERIALIZABLE,
                                             SC_WRITE_METHOD, JavaClassDesc)

    rng = random.Random(1234)
    prim_types = list("BCDFIJSZ")

    def rand_value(depth, shared):
        kind = rng.randrange(6 if depth < 3 else 4)
        if kind == 0:
            return None
        if kind == 1:
            return "s%d" % rng.randrange(5)  # small pool: exercises refs
        if kind == 2:
            t = rng.choice(prim_types)
            _fmt, dt = _PRIM[t]
            vals = np.array([rng.randrange(0, 100) for _ in range(
                rng.randrange(0, 9))]).astype(dt)
            return JavaArray(JavaClassDesc("[" + t, 1, 2, [], None), vals)
        if kind == 3 and shared:
            return rng.choice(shared)  # back-reference to an earlier object
        return rand_obj(depth + 1, shared)

    def rand_obj(depth, shared):
        nf = rng.randrange(0, 4)
        fields, vals = [], {}
        for i in range(nf):
            if rng.random() < 0.5:
                t = rng.choice(prim_types)
                fields.append((t, f"p{i}", None))
                vals[f"p{i}"] = (rng.randrange(0, 100) if t != "Z"
                                 else bool(rng.randrange(2)))
                if t == "D" or t == "F":
                    vals[f"p{i}"] = float(vals[f"p{i}"])
            else:
                fields.append(("L", f"o{i}", "Ljava/lang/Object;"))
                vals[f"o{i}"] = rand_value(depth, shared)
        flags = SC_SERIALIZABLE
        ann = []
        if rng.random() < 0.3:
            flags |= SC_WRITE_METHOD
            ann = [b"\x01\x02\x03", "annot"]
        sup = None
        if depth < 2 and rng.random() < 0.3:
            sup = JavaClassDesc(f"com.fuzz.Super{rng.randrange(3)}",
                                rng.randrange(1 << 40), SC_SERIALIZABLE,
                                [("I", "sx", None)], None)
            vals["sx"] = rng.randrange(1000)
        cd = JavaClassDesc(f"com.fuzz.C{rng.randrange(8)}",
                           rng.randrange(1 << 40), flags, fields, sup)
        o = JavaObject(cd, vals)
        if ann:
            o.annotations[cd.name] = ann
        shared.append(o)
        return o

    def compare(a, b, depth=0):
        assert depth < 50
        if isinstance(a, JavaObject):
            assert isinstance(b, JavaObject) and a.classname == b.classname
            assert set(a.fields) == set(b.fields)
            for k1 in a.fields:
                compare(a.fields[k1], b.fields[k1], depth + 1)
            assert set(a.annotations) == set(b.annotations)
            for cls in a.annotations:
                aa, bb = a.annotations[cls], b.annotations[cls]
                assert len(aa) == len(bb), cls
                for x, y in zip(aa, bb):
                    compare(x, y, depth + 1)
        elif isinstance(a, JavaArray):
            np.testing.assert_array_equal(np.asarray(a.values),
                                          np.asarray(b.values))
        elif isinstance(a, (bytes, bytearray)):
            assert bytes(a) == bytes(b)
        else:
            assert a == b, (a, b)

    for trial in range(25):
        shared = []
        root = rand_obj(0, shared)
        w = JavaWriter()
        w.write_object(root)
        data = w.getvalue()
        [back] = loads(data)
        compare(root, back)
        # re-serializing the parsed graph reproduces the stream byte for
        # byte (same handle assignment order)
        w2 = JavaWriter()
        w2.write_object(back)
        assert w2.getvalue() == data, f"trial {trial}: bytes drifted"


def test_blockdata_long_payload_roundtrip():
    """writeObject annotation payloads over 255 bytes take the
    TC_BLOCKDATALONG frame."""
    from bigdl_torch.interop.javaser import JavaClassDesc, SC_WRITE_METHOD

    cd = JavaClassDesc("com.example.Blob", 9, 2 | SC_WRITE_METHOD,
                       [("I", "n", None)], None)
    payload = bytes(range(256)) * 5  # 1280 bytes: needs the long frame
    o = JavaObject(cd, {"n": 1})
    o.annotations[cd.name] = [payload]
    w = JavaWriter()
    w.write_object(o)
    data = w.getvalue()
    assert b"\x7a\x00\x00\x05\x00" in data  # TC_BLOCKDATALONG + int32 len
    [back] = loads(data)
    assert bytes(back.annotations[cd.name][0]) == payload


def test_threshold_inplace_flag_roundtrips(tmp_path):
    """Threshold(ip=True) keeps its inPlace wire flag through save/load."""
    m = _built(nn.Sequential().add(nn.Threshold(0.5, -1.0, ip=True)))
    p = str(tmp_path / "th.bigdl")
    bigdl_fmt.save(m, p)
    m2 = bigdl_fmt.load(p, device="cpu")
    assert m2.layers[0].ip is True
    with open(p, "rb") as fh:
        contents = load_stream(fh)
    [root] = [c for c in contents if isinstance(c, JavaObject)]
    th = root.fields["modules"].fields["array"].values[0]
    assert th.fields["inPlace"] is True


def test_layerwise_grad_scale_survives_migration(tmp_path):
    """scale_w/scale_b (the reference's AbstractModule scaleW/scaleB) round
    trip as the attributes the Optimizer's gradient scaling reads."""
    m = nn.Sequential()
    lin = nn.Linear(6, 4)
    lin.scale_w = 2.0
    lin.scale_b = 0.5
    m.add(lin)
    m.add(nn.Tanh())
    rec = nn.Recurrent(nn.RnnCell(4, 4))
    rec.layers[0].scale_w = 3.0
    m2 = nn.Sequential()
    m2.add(rec)
    m.add(nn.Reshape([4]))
    _built(m)
    _built(m2, 1)

    p1 = str(tmp_path / "scaled.bigdl")
    bigdl_fmt.save(m, p1)
    back = bigdl_fmt.load(p1, device="cpu")
    assert back.layers[0].scale_w == 2.0
    assert back.layers[0].scale_b == 0.5
    assert back._grad_scales()[:2] == [2.0, 0.5]  # weight, bias
    with open(p1, "rb") as fh:
        raw = fh.read()
    assert b"scaleW" in raw

    p2 = str(tmp_path / "scaled_rnn.bigdl")
    bigdl_fmt.save(m2, p2)
    back2 = bigdl_fmt.load(p2, device="cpu")
    assert back2.layers[0].layers[0].scale_w == 3.0


def test_share_convolution_resnet_style_roundtrip(tmp_path):
    """SpatialShareConvolution (the reference ResNet's optnet path) loads,
    and re-exports under its own class name."""
    m = nn.Sequential()
    m.add(nn.SpatialShareConvolution(3, 8, 3, 3, pad_w=1, pad_h=1))
    m.add(nn.SpatialBatchNormalization(8))
    m.add(nn.ReLU())
    _built(m)
    x = _x(1, (2, 6, 6, 3))
    p = str(tmp_path / "share.bigdl")
    bigdl_fmt.save(m, p)
    raw = open(p, "rb").read()
    assert b"SpatialShareConvolution" in raw
    m2 = bigdl_fmt.load(p, device="cpu")
    assert type(m2.layers[0]).__name__ == "SpatialShareConvolution"
    np.testing.assert_allclose(_forward(m2, x), _forward(m, x), rtol=1e-5,
                               atol=1e-6)


def test_paralleltable_maptable_squeeze_roundtrip(tmp_path):
    """The treeLSTMSentiment front half's plumbing: MapTable's shared
    child (field ``module``), ParallelTable over a table input, Squeeze's
    1-based dims array."""
    m = nn.Sequential()
    ct = nn.ConcatTable()
    ct.add(nn.Identity())
    ct.add(nn.Identity())
    m.add(ct)
    m.add(nn.MapTable(nn.Squeeze(2)))
    pt = nn.ParallelTable()
    pt.add(nn.Linear(6, 4))
    pt.add(nn.Tanh())
    m.add(pt)
    m.add(nn.JoinTable(-1))
    _built(m)
    x = _x(1, (3, 6, 1))
    p = str(tmp_path / "tree_front.bigdl")
    bigdl_fmt.save(m, p)
    m2 = bigdl_fmt.load(p, device="cpu")
    assert isinstance(m2.layers[1], nn.MapTable)
    assert isinstance(m2.layers[2], nn.ParallelTable)
    assert m2.layers[1].layers[0].dim == 2
    np.testing.assert_allclose(_forward(m2, x), _forward(m, x), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------- tests/test_convbn.py's de-fuse

def test_residual_tail_bigdl_format_defuses(tmp_path):
    """A tail-fused model is written de-fused, as the reference block shape
    (ConcatTable -> CAddTable -> ReLU); the reload forwards identically."""
    from bigdl_torch.models.resnet import ShortcutType, _bottleneck

    blk, _ = _bottleneck(16, 4, 1, ShortcutType.B)
    nn.fuse_conv_bn(blk)
    assert any(type(m).__name__ == "ConvBNAddReLU" for m in blk.layers)
    _built(blk)
    x = _x(1, (2, 6, 6, 16))
    p = str(tmp_path / "tail.bigdl")
    bigdl_fmt.save(blk, p)
    m2 = bigdl_fmt.load(p, device="cpu")
    assert not any(type(m).__name__ in ("ConvBNAddReLU", "ConvBN")
                   for m in m2.modules())
    np.testing.assert_allclose(_forward(m2, x), _forward(blk, x), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------- tests/test_wire_audit.py

def _kitchen_sink_models(pkg):
    """The wire audit's models, built from ``pkg`` (either package's nn)."""
    cnn = pkg.Sequential()
    cnn.add(pkg.SpatialZeroPadding(1, 1, 1, 1))
    cnn.add(pkg.SpatialConvolution(3, 8, 3, 3))
    cnn.add(pkg.SpatialShareConvolution(8, 8, 1, 1))
    cnn.add(pkg.SpatialBatchNormalization(8))
    cnn.add(pkg.ReLU())
    cnn.add(pkg.SpatialCrossMapLRN(5))
    cnn.add(pkg.SpatialMaxPooling(2, 2, 2, 2))
    branch = pkg.Concat(-1)
    b1 = pkg.Sequential()
    b1.add(pkg.SpatialConvolution(8, 4, 1, 1))
    b1.add(pkg.Threshold(0.1, 0.0))
    b2 = pkg.Sequential()
    b2.add(pkg.SpatialConvolution(8, 4, 1, 1))
    b2.add(pkg.Power(2.0))
    branch.add(b1)
    branch.add(b2)
    cnn.add(branch)
    ct = pkg.ConcatTable()
    ct.add(pkg.Identity())
    ct.add(pkg.Identity())
    cnn.add(ct)
    cnn.add(pkg.CAddTable())
    cnn.add(pkg.SpatialAveragePooling(2, 2, 2, 2))
    cnn.add(pkg.Reshape([4 * 1 * 1]))
    cnn.add(pkg.View(4))
    cnn.add(pkg.Dropout(0.5))
    cnn.add(pkg.Linear(4, 4))
    cnn.add(pkg.Tanh())
    cnn.add(pkg.Sigmoid())
    cnn.add(pkg.LogSoftMax())

    joined = pkg.Sequential()
    jt = pkg.ConcatTable()
    jt.add(pkg.Identity())
    jt.add(pkg.Identity())
    joined.add(jt)
    joined.add(pkg.MapTable(pkg.Squeeze(1)))
    joined.add(pkg.JoinTable(-1, 0))
    joined.add(pkg.BatchNormalization(8))

    rnn_ = pkg.Sequential()
    rnn_.add(pkg.Recurrent(pkg.RnnCell(4, 6)))
    rnn_.add(pkg.TimeDistributed(pkg.Linear(6, 3)))

    lstm = pkg.Sequential()
    lstm.add(pkg.Recurrent(pkg.LSTM(4, 6)))

    gru = pkg.Sequential()
    gru.add(pkg.Recurrent(pkg.GRU(4, 6)))

    peep = pkg.Sequential()
    peep.add(pkg.Recurrent(pkg.LSTMPeephole(4, 6)))

    text = pkg.Sequential()
    text.add(pkg.LookupTable(10, 8, one_based=True))
    text.add(pkg.TemporalConvolution(8, 6, 3))

    tree = pkg.Sequential()
    tree.add(pkg.BinaryTreeLSTM(4, 5))

    inp = pkg.Input()
    h = pkg.Linear(5, 5)(inp)
    a = pkg.ReLU()(h)
    b = pkg.Tanh()(h)
    out = pkg.CAddTable()([a, b])
    graph = pkg.Graph(inp, out)

    return [cnn, joined, rnn_, lstm, gru, peep, text, tree, graph]


KITCHEN = ["cnn", "joined", "rnn", "lstm", "gru", "peep", "text", "tree",
           "graph"]


def _collect_classdescs(models) -> dict:
    """name -> classdesc for every bigdl class in the port's streams."""
    from bigdl_torch.interop.bigdl import (_DescCache, _fill_base_fields,
                                           _w_module)
    from bigdl_torch.utils.convert import to_reference_tree

    descs = {}
    for m in models:
        _built(m)
        params, state = to_reference_tree(m)
        dc = _DescCache()
        root = _w_module(dc, m, params, state)
        _fill_base_fields(root)
        w = JavaWriter()
        w.write_object(root)
        [back] = loads(w.getvalue())

        def walk(o, seen):
            if id(o) in seen:
                return
            seen.add(id(o))
            if isinstance(o, JavaObject):
                cd = o.classdesc
                while cd is not None:
                    descs.setdefault(cd.name, cd)
                    cd = cd.super_desc
                for v in o.fields.values():
                    walk(v, seen)
                for anns in o.annotations.values():
                    for a in anns:
                        walk(a, seen)
            elif isinstance(o, JavaArray) and o.values is not None \
                    and getattr(o.values, "dtype", None) is None:
                for v in o.values:
                    walk(v, seen)

        walk(back, set())
    return descs


audited = pytest.mark.skipif(
    not os.path.isdir(wire_audit._REF),
    reason="reference checkout not present (installed-wheel lane)")


@pytest.fixture(scope="module")
def kitchen_descs():
    return _collect_classdescs(_kitchen_sink_models(nn))


@audited
def test_every_emitted_classdesc_matches_scala_source(kitchen_descs):
    errors = []
    n = 0
    for name, cd in sorted(kitchen_descs.items()):
        if not name.startswith(wire_audit._PKG):
            continue
        n += 1
        errors += wire_audit.audit_classdesc(cd)
    assert n >= 30, f"only {n} bigdl classdescs audited"
    assert not errors, "wire-format drift vs Scala source:\n" + \
        "\n".join(errors)


@audited
def test_writer_emits_every_declared_nontransient_field(kitchen_descs):
    errors = []
    checked = 0
    allowed = wire_audit._ALLOWED_OMISSIONS
    for name, cd in sorted(kitchen_descs.items()):
        if not name.startswith(wire_audit._PKG):
            continue
        short = name.rsplit(".", 1)[-1]
        own = wire_audit.scala_own_fields(short)
        if not own:
            continue
        checked += 1
        emitted = {fname for _t, fname, _sig in cd.fields}
        for fname in sorted(own):
            if fname in emitted or (short, fname) in allowed \
                    or ("*", fname) in allowed:
                continue
            errors.append(f"{name}.{fname}: declared non-transient but "
                          "never emitted")
    assert checked >= 20, f"only {checked} classes had auditable source"
    assert not errors, "writer omits declared non-transient fields:\n" + \
        "\n".join(errors)


@audited
def test_audit_covers_every_suid_entry(kitchen_descs):
    missing = [name for name in bigdl_fmt._SUID
               if name.startswith(wire_audit._PKG)
               and name not in kitchen_descs]
    assert not missing, f"_SUID entries never exercised: {missing}"


@audited
def test_audit_detects_a_wrong_field_and_wrong_suid():
    from bigdl_torch.interop.javaser import JavaClassDesc

    pkg = wire_audit._PKG
    bogus = JavaClassDesc(pkg + "nn.Linear", 359656776803598943, 2,
                          [("I", "notAField", None)], None)
    assert any("notAField" in e for e in wire_audit.audit_classdesc(bogus))
    wrong_suid = JavaClassDesc(pkg + "nn.Linear", 42, 2,
                               [("I", "inputSize", None)], None)
    assert any("SUID" in e for e in wire_audit.audit_classdesc(wrong_suid))
    wrong_type = JavaClassDesc(pkg + "nn.Linear", 359656776803598943, 2,
                               [("D", "inputSize", None)], None)
    assert any("primitive" in e
               for e in wire_audit.audit_classdesc(wrong_type))


@audited
def test_super_chains_match_scala(kitchen_descs):
    errors = []
    checked = 0
    for name, cd in sorted(kitchen_descs.items()):
        if not name.startswith(wire_audit._PKG):
            continue
        checked += 1
        emitted = []
        c = cd.super_desc
        while c is not None:
            emitted.append(c.name.rsplit(".", 1)[-1])
            c = c.super_desc
        expected = wire_audit.scala_parent_chain(name.rsplit(".", 1)[-1])
        if emitted != expected:
            errors.append(f"{name}: emitted super chain {emitted} != "
                          f"source {expected}")
    assert checked >= 30
    assert not errors, "super-chain drift vs Scala source:\n" + \
        "\n".join(errors)


# ----------------------------------------------- the port vs the JAX package

def _kitchen_pair(i):
    ref = _kitchen_sink_models(rnn)[i]
    ref.build(jax.random.PRNGKey(i))
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    state = jax.tree_util.tree_map(np.asarray, ref.state)
    port = _built(_kitchen_sink_models(nn)[i])
    load_reference_tree(port, params, state)
    return ref, port


def test_kitchen_sink_covers_every_suid_entry():
    """The byte comparison below reaches every class the writer knows."""
    descs = _collect_classdescs(_kitchen_sink_models(nn))
    missing = [name for name in bigdl_fmt._SUID
               if name.startswith(wire_audit._PKG) and name not in descs]
    assert not missing, missing


@pytest.mark.parametrize("i", range(len(KITCHEN)), ids=KITCHEN)
def test_kitchen_sink_streams_are_the_references(tmp_path, i):
    from bigdl_tpu.interop import bigdl as ref_fmt
    ref, port = _kitchen_pair(i)
    ref_fmt.save(ref, str(tmp_path / "ref.bigdl"))
    bigdl_fmt.save(port, str(tmp_path / "port.bigdl"))
    a = (tmp_path / "ref.bigdl").read_bytes()
    assert a[:2] == b"\xac\xed" and a == (tmp_path / "port.bigdl").read_bytes()
    # each package loads the other's stream into the same trees
    from bigdl_torch.utils.convert import to_reference_tree
    back = bigdl_fmt.load(str(tmp_path / "ref.bigdl"), device="cpu")
    rback = ref_fmt.load(str(tmp_path / "port.bigdl"))
    got = jax.tree_util.tree_leaves(to_reference_tree(back))
    want = jax.tree_util.tree_leaves(
        (jax.tree_util.tree_map(np.asarray, rback.params),
         jax.tree_util.tree_map(np.asarray, rback.state)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_lenet_like_streams_forward_alike(tmp_path):
    """The fixture's model, loaded and written again by each package: the
    two streams are byte-identical, each loads in the other package, and
    the eval forwards agree within 1e-5."""
    from bigdl_tpu.interop import bigdl as ref_fmt
    ref = ref_fmt.load(FIXTURE)
    x = np.fromfile(FIXTURE + ".x", dtype=np.float32).reshape(2, 28, 28, 1)
    want, _ = ref.apply(ref.params, ref.state, jnp.asarray(x))
    port = bigdl_fmt.load(FIXTURE, device="cpu")
    ref_fmt.save(ref, str(tmp_path / "ref.bigdl"))
    bigdl_fmt.save(port, str(tmp_path / "port.bigdl"))
    assert (tmp_path / "port.bigdl").read_bytes() == \
        (tmp_path / "ref.bigdl").read_bytes()
    rback = ref_fmt.load(str(tmp_path / "port.bigdl"))
    got, _ = rback.apply(rback.params, rback.state, jnp.asarray(x))
    back = bigdl_fmt.load(str(tmp_path / "ref.bigdl"), device="cpu")
    np.testing.assert_allclose(_forward(port, x), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_forward(back, x), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
