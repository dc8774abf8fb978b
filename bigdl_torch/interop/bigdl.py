"""Load and save models in the reference's native format (Java serialization).

Counterpart of ``bigdl_tpu/interop/bigdl.py``.  The reference's
``Module.save`` / ``Module.load`` serialize the module object graph with
``ObjectOutputStream`` (``nn/Module.scala:41-43``, ``utils/File.scala:25``);
``example/loadmodel/ModelValidator.scala`` treats "bigdl" as a format
beside caffe and torch.  :func:`load` parses any object stream with
``interop/javaser.py`` (the stream is self-describing), walks the module
tree by class name and rebuilds the port's modules, built on the device
the caller names (the CUDA device by default; it raises without one) with
the weights installed through ``Module.attach``
(``utils/convert.py`` ``load_reference_tree``, which raises on any
mismatch).  :func:`save` writes the same wire format for the supported
layers from the module's own leaves (``to_reference_tree``), byte for
byte as the JAX package writes it; a fused model (``nn.fuse_conv_bn``) is
written de-fused, as the reference's classes are.

Layouts (as the Caffe and Torch importers convert them):
  Linear weight   (out, in)                        -> (in, out)
  SpatialConvolution weight (g, out/g, in/g, kh, kw) -> HWIO (kh, kw, in/g, out)
  BatchNormalization runningMean/runningVar          -> state tree

Unknown layer classes raise with the class name, as
``interop/tensorflow.py`` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .javaser import (SC_SERIALIZABLE, SC_WRITE_METHOD, JavaArray,
                      JavaClassDesc, JavaObject, JavaWriter, load_stream)

__all__ = ["load", "save"]

_PKG = "com.intel.analytics.bigdl.nn."
_TENSOR = "com.intel.analytics.bigdl.tensor.DenseTensor"
_STORAGE = "com.intel.analytics.bigdl.tensor.ArrayStorage"
# SerialVersionUIDs from the reference source (@SerialVersionUID
# annotations) — a JVM ObjectInputStream validates these on read, so every
# class the writer emits carries its real value
_SUID = {
    _TENSOR: 5876322619614900645,
    _PKG + "Sequential": 5375403296928513267,
    _PKG + "Linear": 359656776803598943,
    _PKG + "ReLU": 1208478077576570643,
    _PKG + "SpatialConvolution": -8446523046224797382,
    _PKG + "SpatialShareConvolution": 4479683852714800631,
    _PKG + "SpatialMaxPooling": 2277597677473874749,
    _PKG + "SpatialAveragePooling": 4533142511857387857,
    _PKG + "BatchNormalization": -3181824540272906068,
    _PKG + "SpatialBatchNormalization": -9106336963903528047,
    _PKG + "Reshape": -830146931795053244,
    _PKG + "View": 1238814703013238333,
    _PKG + "Dropout": -4636332259181125718,
    _PKG + "Identity": -8429221694319933625,
    _PKG + "Tanh": 9062199894710333035,
    _PKG + "Sigmoid": 6855417348268610044,
    _PKG + "LogSoftMax": -2954501946670913825,
    _PKG + "Concat": -5218461876031660707,
    _PKG + "ConcatTable": -704681653938468956,
    _PKG + "JoinTable": -8435694717504118735,
    _PKG + "CAddTable": 7959261460060075605,
    _PKG + "SpatialZeroPadding": -5144173515559923276,
    _PKG + "SpatialCrossMapLRN": 3641570491004969703,
    _PKG + "Threshold": 3953292249027271493,
    _PKG + "Power": -6637789603381436472,
    # sequence/embedding zoo (round-4 verdict #4)
    _PKG + "Graph": -2896121321564992779,
    _PKG + "Input": -8525406230282608924,
    "com.intel.analytics.bigdl.utils.Node": -6021651923538325999,
    _PKG + "LookupTable": -4832171200145114633,
    _PKG + "LSTM": -8176191554025511686,
    _PKG + "GRU": 6717988395573528459,
    _PKG + "ParallelTable": -1197848941394786045,
    _PKG + "NarrowTable": 8046335768231475724,
    _PKG + "SelectTable": 8787233248773612598,
    _PKG + "FlattenTable": 7620301574431959449,
    _PKG + "SplitTable": -4318640284973082779,
    _PKG + "CMulTable": 8888147326550637025,
    _PKG + "Narrow": 988790441682879293,
    _PKG + "MulConstant": -8747642888169310696,
    _PKG + "AddConstant": -1572711921601326233,
    _PKG + "Container": -2120105647780417237,
    _PKG + "LSTMPeephole": -7566757838561436619,
    _PKG + "MapTable": 4403280698280280268,
    _PKG + "Squeeze": 7998127436291978408,
    _PKG + "CMul": 8888147326550637025,  # same literal as CMulTable in src
    # JDK box classes (MulConstant/AddConstant's derived `scalar: T` field
    # erases to a boxed java.lang.Float) — SUIDs are JDK spec constants
    "java.lang.Number": -8742448824652078965,
    "java.lang.Float": -2671257302660747028,
    "java.lang.Double": -9172774392245257468,
    # Recurrent / RnnCell / TimeDistributed / TemporalConvolution /
    # AbstractModule / Cell / BiRecurrent / Reverse carry no
    # @SerialVersionUID annotation in the reference source; the JVM
    # computes a structural default (a SHA-1 over the compiled class's
    # members) that cannot be derived without a JVM — they fall back to
    # _DescCache's default of 1.
}


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _to_numpy(t: Optional[JavaObject]) -> Optional[np.ndarray]:
    """DenseTensor -> numpy via (_storage, _storageOffset, _size, _stride)."""
    if t is None:
        return None
    if t.classname != _TENSOR:
        raise ValueError(f"expected DenseTensor, got {t.classname}")
    storage = t.fields["_storage"]
    values = np.asarray(storage.fields["values"].values
                        if isinstance(storage.fields["values"], JavaArray)
                        else storage.fields["values"])
    ndim = int(t.fields["nDimension"])
    if ndim == 0:
        return np.zeros((0,), values.dtype)
    size = np.asarray(t.fields["_size"].values)[:ndim]
    stride = np.asarray(t.fields["_stride"].values)[:ndim]
    off = int(t.fields["_storageOffset"])
    out = np.lib.stride_tricks.as_strided(
        values[off:], shape=tuple(int(s) for s in size),
        strides=tuple(int(st) * values.itemsize for st in stride))
    return np.array(out)  # copy: detach from the storage buffer


def _children(obj: JavaObject) -> List[JavaObject]:
    """Container.modules: scala ArrayBuffer (fields `array` + `size0`)."""
    buf = obj.fields.get("modules")
    if buf is None:
        return []
    arr = buf.fields.get("array")
    n = int(buf.fields.get("size0", 0))
    items = arr.values[:n] if isinstance(arr, JavaArray) else []
    return [m for m in items if m is not None]


def _build(obj: JavaObject):
    """Map one reference module object -> (port module, params, state);
    re-applies the stream's AbstractModule scaleW/scaleB so layer-wise
    scales survive migration."""
    m, p, s = _build_raw(obj)
    f = obj.fields
    for attr, key in (("scale_w", "scaleW"), ("scale_b", "scaleB")):
        v = f.get(key)
        if v is not None and float(v) != 1.0:
            setattr(m, attr, float(v))
    return m, p, s


def _build_raw(obj: JavaObject):
    from .. import nn

    cls = obj.classname
    short = cls[len(_PKG):] if cls.startswith(_PKG) else cls
    f = obj.fields
    if short in ("Sequential", "Concat", "ConcatTable", "ParallelTable",
                 "MapTable"):
        if short == "Sequential":
            container = nn.Sequential()
        elif short == "ParallelTable":
            container = nn.ParallelTable()
        elif short == "MapTable":
            # one SHARED child; the reference also stores per-application
            # clones in `modules` — only the master (field `module`) maps
            m, p, s = _build(f["module"])
            return nn.MapTable(m), [p], [s]
        elif short == "Concat":
            # reference dimension is 1-based over NCHW: 2 = channels, which
            # is the LAST axis in this framework's NHWC layout (the only
            # concat axis the zoo models use — fail loud otherwise)
            dim = int(f.get("dimension", 2))
            if dim != 2:
                raise ValueError(
                    f"bigdl format: Concat over NCHW dim {dim} has no "
                    "NHWC mapping here (only channel concat, dim=2)")
            container = nn.Concat(-1)
        else:
            container = nn.ConcatTable()
        params, states = [], []
        for child in _children(obj):
            m, p, s = _build(child)
            container.add(m)
            params.append(p)
            states.append(s)
        return container, params, states
    if short == "Linear":
        m = nn.Linear(int(f["inputSize"]), int(f["outputSize"]),
                      with_bias=f.get("withBias", True))
        # both sides store (out, in) — nn.Linear keeps the reference layout
        p = {"weight": _to_numpy(f["weight"])}
        if f.get("withBias", True) and f.get("bias") is not None:
            p["bias"] = _to_numpy(f["bias"])
        return m, p, {}
    if short in ("SpatialConvolution", "SpatialShareConvolution"):
        g = int(f.get("nGroup", 1))
        ctor = (nn.SpatialShareConvolution
                if short == "SpatialShareConvolution"
                else nn.SpatialConvolution)
        m = ctor(
            int(f["nInputPlane"]), int(f["nOutputPlane"]),
            int(f["kernelW"]), int(f["kernelH"]),
            int(f.get("strideW", 1)), int(f.get("strideH", 1)),
            int(f.get("padW", 0)), int(f.get("padH", 0)), g,
            with_bias=bool(f.get("withBias", True))
            and f.get("bias") is not None)
        w = _to_numpy(f["weight"])  # (g, out/g, in/g, kh, kw)
        # -> HWIO (kh, kw, in/g, out):  merge the group dim into out
        w = w.transpose(3, 4, 2, 0, 1).reshape(
            w.shape[3], w.shape[4], w.shape[2], -1)
        p = {"weight": w}
        if f.get("bias") is not None:
            p["bias"] = _to_numpy(f["bias"])
        return m, p, {}
    if short in ("SpatialBatchNormalization", "BatchNormalization"):
        ctor = (nn.SpatialBatchNormalization
                if short == "SpatialBatchNormalization"
                else nn.BatchNormalization)
        m = ctor(int(f["nOutput"]), eps=float(f.get("eps", 1e-5)),
                 momentum=float(f.get("momentum", 0.1)),
                 affine=bool(f.get("affine", True)))
        p = {}
        if f.get("weight") is not None:
            p = {"weight": _to_numpy(f["weight"]),
                 "bias": _to_numpy(f["bias"])}
        s = {"running_mean": _to_numpy(f["runningMean"]),
             "running_var": _to_numpy(f["runningVar"])}
        return m, p, s
    if short == "SpatialMaxPooling":
        return nn.SpatialMaxPooling(int(f["kW"]), int(f["kH"]),
                                    int(f["dW"]), int(f["dH"]),
                                    int(f.get("padW", 0)),
                                    int(f.get("padH", 0))), {}, {}
    if short == "SpatialAveragePooling":
        return nn.SpatialAveragePooling(int(f["kW"]), int(f["kH"]),
                                        int(f.get("dW", 1)),
                                        int(f.get("dH", 1)),
                                        int(f.get("padW", 0)),
                                        int(f.get("padH", 0))), {}, {}
    if short == "Reshape":
        size = [int(x) for x in np.asarray(f["size"].values)]
        return nn.Reshape(size), {}, {}
    if short == "View":
        sizes = [int(x) for x in np.asarray(f["sizes"].values)]
        return nn.View(*sizes), {}, {}
    if short == "CAddTable":
        return nn.CAddTable(bool(f.get("inplace", False))), {}, {}
    if short == "CMulTable":
        return nn.CMulTable(), {}, {}
    if short == "FlattenTable":
        return nn.FlattenTable(), {}, {}
    if short == "JoinTable":
        dim = int(f.get("dimension", 2))
        if dim != 2:
            raise ValueError(f"bigdl format: JoinTable over NCHW dim {dim} "
                             "has no NHWC mapping here (channel only)")
        return nn.JoinTable(-1,
                            int(f.get("nInputDims", 0))), {}, {}
    if short == "SpatialZeroPadding":
        return nn.SpatialZeroPadding(int(f["padLeft"]), int(f["padRight"]),
                                     int(f["padTop"]),
                                     int(f["padBottom"])), {}, {}
    if short == "SpatialCrossMapLRN":
        return nn.SpatialCrossMapLRN(int(f.get("size", 5)),
                                     float(f.get("alpha", 1.0)),
                                     float(f.get("beta", 0.75)),
                                     float(f.get("k", 1.0))), {}, {}
    if short == "Threshold":
        return nn.Threshold(float(f.get("threshold", 1e-6)),
                            float(f.get("value", 0.0)),
                            bool(f.get("inPlace", False))), {}, {}
    if short == "Power":
        return nn.Power(float(f["power"]), float(f.get("scale", 1.0)),
                        float(f.get("shift", 0.0))), {}, {}
    if short == "Squeeze":
        dims = f.get("dims")
        if bool(f.get("batchMode", False)) and dims is None:
            # squeeze-all + batch-mode re-adds the batch singleton
            # (Squeeze.scala:58-60) — unrepresentable here, fail loud
            raise ValueError("bigdl format: Squeeze(batchMode=true, "
                             "dims=null) has no mapping here")
        if dims is not None:
            d = [int(v) for v in np.asarray(dims.values)]
            if len(d) != 1:
                raise ValueError(f"bigdl format: Squeeze over dims {d} has "
                                 "no single-axis mapping here")
            # reference dims are 1-based including batch
            return nn.Squeeze(d[0] - 1), {}, {}
        return nn.Squeeze(), {}, {}
    if short == "ReLU":
        return nn.ReLU(), {}, {}
    if short == "Tanh":
        return nn.Tanh(), {}, {}
    if short == "Sigmoid":
        return nn.Sigmoid(), {}, {}
    if short == "LogSoftMax":
        return nn.LogSoftMax(), {}, {}
    if short == "Dropout":
        return nn.Dropout(float(f.get("initP", 0.5))), {}, {}
    if short == "Identity":
        return nn.Identity(), {}, {}
    from . import bigdl_seq
    built = bigdl_seq.build_seq(short, obj, _build)
    if built is not None:
        return built
    raise ValueError(
        f"bigdl format: unsupported layer class {cls} — extend "
        "interop/bigdl._build (fail-loud, like the TensorFlow importer)")


def _parse(data: bytes):
    """The stream's root module, not built: (module, params, state), the
    trees with numpy leaves."""
    import io

    contents = load_stream(io.BytesIO(data))
    roots = [c for c in contents if isinstance(c, JavaObject)]
    if not roots:
        raise ValueError("bigdl stream: no serialized object found")
    return _build(roots[0])


def load(path: str, device=None):
    """Load a reference-format model file -> a built port Module on
    ``device`` (default the CUDA device), weights installed, ready for
    forward/predict."""
    with open(path, "rb") as fh:
        return load_bytes(fh.read(), device)


def load_bytes(data: bytes, device=None):
    """As :func:`load`, from in-memory bytes (a remote path is read through
    ``utils/file_io.py`` and handed here)."""
    import torch

    from ..common import resolve_device
    device = resolve_device(device)
    module, params, state = _parse(data)
    # every leaf is overwritten by attach: the generator only fills the
    # tensors that build makes
    module.build(device, torch.Generator().manual_seed(0))
    module.attach(params, state)
    return module


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

# JVM-grade classdesc machinery.  A real ObjectInputStream matches the
# stream's classdesc hierarchy against the local classes, so the writer
# must emit (a) the actual superclass chain (Linear -> TensorModule ->
# AbstractModule, ReLU -> Threshold -> ..., containers -> Container),
# (b) AbstractModule's own non-transient base fields, and (c) fields in
# the JOS canonical order (primitives before objects, each sorted by
# name — java.io.ObjectStreamField.compareTo).  The name-based reader is
# order-agnostic, so old flat streams (the frozen fixture) still load.
_ABSTRACTNN = "com.intel.analytics.bigdl.nn.abstractnn."
_AM = _ABSTRACTNN + "AbstractModule"
_TM = _ABSTRACTNN + "TensorModule"
_CONTAINER = _PKG + "Container"
_CELL = _PKG + "Cell"
_ACTIVITY_SIG = "Lcom/intel/analytics/bigdl/nn/abstractnn/Activity;"
_STRING_SIG = "Ljava/lang/String;"
_BUF_SIG = "Lscala/collection/mutable/ArrayBuffer;"
# AbstractModule.scala:58-341 non-transient members
_AM_FIELDS = [
    ("D", "scaleW", None), ("D", "scaleB", None),
    ("J", "forwardTime", None), ("J", "backwardTime", None),
    ("L", "output", _ACTIVITY_SIG), ("L", "gradInput", _ACTIVITY_SIG),
    ("Z", "train", None),
    ("L", "name", _STRING_SIG), ("L", "namePostfix", _STRING_SIG),
    ("L", "line", _STRING_SIG),
    ("L", "engineType", "Lcom/intel/analytics/bigdl/utils/EngineType;"),
]
# shared field lists for classes that appear both as a concrete class and
# as someone's superclass (ReLU extends Threshold; SpatialBatchNormalization
# extends BatchNormalization) — one definition so the descs cannot diverge
_TENSOR_SIG = "Lcom/intel/analytics/bigdl/tensor/Tensor;"
_THRESHOLD_FIELDS = [("D", "threshold", None), ("D", "value", None),
                     ("Z", "inPlace", None)]
_SCONV_FIELDS = [("I", "nInputPlane", None), ("I", "nOutputPlane", None),
                 ("I", "kernelW", None), ("I", "kernelH", None),
                 ("I", "strideW", None), ("I", "strideH", None),
                 ("I", "padW", None), ("I", "padH", None),
                 ("I", "nGroup", None),
                 ("L", "weight", _TENSOR_SIG), ("L", "bias", _TENSOR_SIG)]
_BN_FIELDS = [("I", "nOutput", None), ("D", "eps", None),
              ("D", "momentum", None), ("Z", "affine", None),
              ("L", "weight", _TENSOR_SIG), ("L", "bias", _TENSOR_SIG),
              ("L", "runningMean", _TENSOR_SIG),
              ("L", "runningVar", _TENSOR_SIG)]
# default values for inherited/base fields the module builders don't set
# explicitly; save() fills them in one walk over the finished object graph
_FILL_DEFAULTS = {
    "scaleW": 1.0, "scaleB": 1.0, "forwardTime": 0, "backwardTime": 0,
    "train": True, "output": None, "gradInput": None, "name": None,
    "namePostfix": "0", "line": "\n", "engineType": None,
    "regularizers": None,
    # ReLU is Threshold(0, 0, ip) in the reference (ReLU.scala)
    "threshold": 0.0, "value": 0.0, "inPlace": False,
}
_PARENT_CONTAINER = {"Sequential", "Concat", "ConcatTable", "ParallelTable",
                     "MapTable", "Recurrent", "BiRecurrent", "Graph"}
_PARENT_CELL = {"RnnCell", "LSTM", "GRU", "LSTMPeephole"}
_PARENT_AM_DIRECT = {"CAddTable", "CMulTable", "JoinTable", "SplitTable",
                     "NarrowTable", "SelectTable", "FlattenTable",
                     "Identity"}


def _canonical(fields):
    """JOS field order: primitives first, each group sorted by name."""
    return sorted(fields, key=lambda f: (0 if f[0] in "BCDFIJSZ" else 1,
                                         f[1]))


class _DescCache:
    """One JavaClassDesc per class per stream (so repeats become refs).
    nn-module classes get their real superclass chain attached
    automatically; fields are stored in JOS canonical order."""

    def __init__(self):
        self.cache: Dict[str, JavaClassDesc] = {}

    def get(self, name: str, fields, super_desc=None) -> JavaClassDesc:
        if name not in self.cache:
            if super_desc is None:
                super_desc = self._auto_super(name)
            self.cache[name] = JavaClassDesc(
                name, _SUID.get(name, 1), SC_SERIALIZABLE,
                _canonical(fields), super_desc)
        return self.cache[name]

    def _auto_super(self, name: str):
        if name == _AM:
            return None
        if name == _TM or name in (_CONTAINER, _CELL):
            # Container.scala:40 / Cell.scala:44 / TensorModule all extend
            # AbstractModule directly
            return self.get(_AM, list(_AM_FIELDS))
        if not name.startswith(_PKG) or name.startswith(_ABSTRACTNN):
            return None
        short = name[len(_PKG):]
        if "." in short:  # nested package (not an nn module class)
            return None
        if short == "ReLU":  # ReLU.scala: extends Threshold
            return self.get(_PKG + "Threshold", list(_THRESHOLD_FIELDS))
        if short == "SpatialBatchNormalization":  # extends BatchNormalization
            return self.get(_PKG + "BatchNormalization", list(_BN_FIELDS))
        if short == "SpatialShareConvolution":  # extends SpatialConvolution
            return self.get(_PKG + "SpatialConvolution",
                            list(_SCONV_FIELDS))
        if short in _PARENT_CONTAINER:
            return self.get(_CONTAINER, [("L", "modules", _BUF_SIG)])
        if short == "BinaryTreeLSTM":  # extends TreeLSTM (TreeLSTM.scala:25)
            return self.get(
                _PKG + "TreeLSTM",
                [("I", "inputSize", None), ("I", "hiddenSize", None),
                 ("L", "memZero", _TENSOR_SIG)])
        if short == "TreeLSTM":
            return self.get(_AM, list(_AM_FIELDS))
        if short in _PARENT_CELL:
            return self.get(_CELL, [
                ("[", "hiddensShape", "[I"),
                ("L", "regularizers",
                 "[Lcom/intel/analytics/bigdl/optim/Regularizer;")])
        if short in _PARENT_AM_DIRECT:
            return self.get(_AM, list(_AM_FIELDS))
        return self.get(_TM, [])  # TensorModule: no fields of its own

    def array(self, signature: str) -> JavaClassDesc:
        return self.get(signature, [])


def _fill_base_fields(root: JavaObject) -> None:
    """Fill inherited-field defaults for every module object in the graph
    (one walk, cycle-safe); unknown missing fields fail loud."""
    seen = set()

    def walk(o):
        if id(o) in seen:
            return
        seen.add(id(o))
        if isinstance(o, JavaArray):
            if o.values is not None and getattr(o.values, "dtype",
                                                None) is None:
                for v in o.values:
                    walk(v)
            return
        if not isinstance(o, JavaObject):
            return
        for cls in o.classdesc.hierarchy():
            for _t, fname, _sig in cls.fields:
                if fname not in o.fields:
                    if fname not in _FILL_DEFAULTS:
                        raise ValueError(
                            f"bigdl format save: {cls.name}.{fname} has no "
                            "value and no known default")
                    o.fields[fname] = _FILL_DEFAULTS[fname]
        for v in list(o.fields.values()):
            walk(v)

    walk(root)


def _w_tensor(dc: _DescCache, a: np.ndarray) -> JavaObject:
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    storage_cd = dc.get(_STORAGE, [("[", "values", "[F")])
    storage = JavaObject(storage_cd, {
        "values": JavaArray(dc.array("[F"), a.reshape(-1))})
    stride = np.cumprod((1,) + a.shape[::-1][:-1])[::-1].astype(np.int32)
    cd = dc.get(_TENSOR, [
        ("I", "_storageOffset", None), ("I", "nDimension", None),
        ("L", "_storage", "Lcom/intel/analytics/bigdl/tensor/Storage;"),
        ("[", "_size", "[I"), ("[", "_stride", "[I")])
    return JavaObject(cd, {
        "_storageOffset": 0, "nDimension": a.ndim, "_storage": storage,
        "_size": JavaArray(dc.array("[I"), np.asarray(a.shape, np.int32)),
        "_stride": JavaArray(dc.array("[I"), stride)})


def _w_buffer(dc: "_DescCache", items) -> JavaObject:
    """scala.collection.mutable.ArrayBuffer wire shape (one definition —
    MapTable, the container branch, and bigdl_seq all share it)."""
    cd = dc.get("scala.collection.mutable.ArrayBuffer",
                [("I", "initialSize", None), ("I", "size0", None),
                 ("[", "array", "[Ljava/lang/Object;")])
    return JavaObject(cd, {
        "initialSize": 16, "size0": len(items),
        "array": JavaArray(dc.array("[Ljava.lang.Object;"), list(items))})


def _scales(m) -> dict:
    """The module's real scale_w/scale_b (AbstractModule.scala:73-74
    scaleW/scaleB) so the layer-wise gradient scale survives migration."""
    return {"scaleW": float(getattr(m, "scale_w", 1.0)),
            "scaleB": float(getattr(m, "scale_b", 1.0))}


def _w_module(dc: _DescCache, m, params, state) -> JavaObject:
    from .. import nn

    def obj(short, prim_fields, obj_fields):
        fields = ([(t, n, None) for t, n, _v in prim_fields] +
                  [("L" if not s.startswith("[") else "[", n, s)
                   for n, s, _v in obj_fields])
        cd = dc.get(_PKG + short, fields)
        vals = {n: v for _t, n, v in prim_fields}
        vals.update({n: v for n, _s, v in obj_fields})
        vals.update(_scales(m))
        return JavaObject(cd, vals)

    t = "Lcom/intel/analytics/bigdl/tensor/Tensor;"
    if isinstance(m, nn.MapTable):
        inner = _w_module(dc, m.layers[0], params[0], state[0])
        cd = dc.get(_PKG + "MapTable",
                    [("L", "module",
                      "Lcom/intel/analytics/bigdl/nn/abstractnn/"
                      "AbstractModule;")])
        return JavaObject(cd, {
            "module": inner, "modules": _w_buffer(dc, [inner]),
            **_scales(m)})
    if isinstance(m, nn.Squeeze):
        if m.dim is not None and m.dim < 0:
            # the reference's squeeze is strictly 1-based positive
            # (DenseTensor.scala:60) — a negative axis cannot be resolved
            # without the input rank, so refuse instead of emitting a
            # stream the JVM rejects at forward time
            raise ValueError(f"bigdl format save: Squeeze(dim={m.dim}) "
                             "needs a non-negative axis")
        return obj("Squeeze",
                   [("Z", "batchMode", False)],
                   [("dims", "[I",
                     JavaArray(dc.array("[I"),
                               np.asarray([m.dim + 1], np.int32))
                     if m.dim is not None else None)])
    if isinstance(m, nn.ConvBNAddReLU):
        # de-fuse to the reference residual-block shape: the tail fusion
        # is the port's rewrite (nn/fused.py), not a reference class —
        # the wire carries ConcatTable(branch, shortcut) -> CAddTable ->
        # ReLU with the params re-nested to match
        head, conv, bn, shortcut = m.layers
        branch = nn.Sequential(*head.layers).add(conv).add(bn)
        seq = (nn.Sequential()
               .add(nn.ConcatTable().add(branch).add(shortcut))
               .add(nn.CAddTable())
               .add(nn.ReLU()))
        hp, cp, bp, sp = params
        hs, cs, bs, ss = state
        return _w_module(dc, seq,
                         [[list(hp) + [cp, bp], sp], {}, {}],
                         [[list(hs) + [cs, bs], ss], {}, {}])
    if isinstance(m, (nn.Sequential, nn.Concat, nn.ConcatTable,
                      nn.ParallelTable)):
        kids = [_w_module(dc, c, p, s)
                for c, p, s in zip(m.layers, params, state)]
        buf = _w_buffer(dc, kids)
        # `modules` lives on the Container superclass desc (attached by
        # _DescCache automatically); only class-own fields are declared here
        if isinstance(m, nn.Concat):
            if m.dimension not in (-1, 3):
                raise ValueError("bigdl format save: only channel Concat "
                                 "maps to the reference's NCHW dim 2")
            cd = dc.get(_PKG + "Concat", [("I", "dimension", None)])
            return JavaObject(cd, {"dimension": 2, "modules": buf,
                                   **_scales(m)})
        # fused subclasses (nn.ConvBN) are the port's rewrite, not a
        # reference class: serialize as the plain Sequential they subclass
        short = ("Sequential" if isinstance(m, nn.Sequential)
                 else type(m).__name__)
        cd = dc.get(_PKG + short, [])
        return JavaObject(cd, {"modules": buf, **_scales(m)})
    if isinstance(m, nn.CAddTable):
        return obj("CAddTable", [("Z", "inplace", bool(m.inplace))], [])
    if isinstance(m, nn.View):
        return obj("View", [],
                   [("sizes", "[I", JavaArray(
                       dc.array("[I"), np.asarray(m.sizes, np.int32)))])
    if isinstance(m, nn.JoinTable):
        if m.dimension not in (-1, 3):
            raise ValueError("bigdl format save: only channel JoinTable "
                             "maps to the reference's NCHW dim 2")
        return obj("JoinTable",
                   [("I", "dimension", 2),
                    ("I", "nInputDims", int(getattr(m, "n_input_dims", 0)))],
                   [])
    if isinstance(m, nn.SpatialZeroPadding):
        return obj("SpatialZeroPadding",
                   [("I", "padLeft", m.l), ("I", "padRight", m.r),
                    ("I", "padTop", m.t), ("I", "padBottom", m.b)], [])
    if isinstance(m, nn.Linear):
        return obj("Linear",
                   [("I", "inputSize", m.input_size),
                    ("I", "outputSize", m.output_size),
                    ("Z", "withBias", m.with_bias)],
                   [("weight", t, _w_tensor(dc, params["weight"])),
                    ("bias", t, _w_tensor(dc, params["bias"])
                     if m.with_bias else None)])
    if isinstance(m, nn.SpatialConvolution):
        kh, kw = m.kernel
        sh, sw = m.stride
        ph, pw = m.pad
        w = np.asarray(params["weight"])  # HWIO
        g = m.n_group
        w5 = w.reshape(kh, kw, w.shape[2], g, -1).transpose(3, 4, 2, 0, 1)
        sconv_cd = dc.get(_PKG + "SpatialConvolution", list(_SCONV_FIELDS))
        cd = (dc.get(_PKG + "SpatialShareConvolution", [],
                     super_desc=sconv_cd)
              if isinstance(m, nn.SpatialShareConvolution) else sconv_cd)
        return JavaObject(cd, {
            "nInputPlane": m.n_input_plane,
            "nOutputPlane": m.n_output_plane,
            "kernelW": kw, "kernelH": kh, "strideW": sw, "strideH": sh,
            "padW": pw, "padH": ph, "nGroup": g,
            "weight": _w_tensor(dc, w5),
            "bias": (_w_tensor(dc, params["bias"])
                     if m.with_bias else None),
            **_scales(m)})
    if isinstance(m, (nn.SpatialBatchNormalization, nn.BatchNormalization)):
        # SpatialBatchNormalization extends BatchNormalization (which holds
        # every field) — the subclass desc is empty with the BN super desc
        bn_cd = dc.get(_PKG + "BatchNormalization", list(_BN_FIELDS))
        cd = (dc.get(_PKG + "SpatialBatchNormalization", [],
                     super_desc=bn_cd)
              if isinstance(m, nn.SpatialBatchNormalization) else bn_cd)
        return JavaObject(cd, {
            "nOutput": m.n_output, "eps": m.eps, "momentum": m.momentum,
            "affine": m.affine,
            "weight": _w_tensor(dc, params["weight"]) if m.affine else None,
            "bias": _w_tensor(dc, params["bias"]) if m.affine else None,
            "runningMean": _w_tensor(dc, state["running_mean"]),
            "runningVar": _w_tensor(dc, state["running_var"]),
            **_scales(m)})
    if isinstance(m, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
        kh, kw = m.kernel
        sh, sw = m.stride
        ph, pw = m.pad
        short = ("SpatialMaxPooling" if isinstance(m, nn.SpatialMaxPooling)
                 else "SpatialAveragePooling")
        return obj(short,
                   [("I", "kW", kw), ("I", "kH", kh), ("I", "dW", sw),
                    ("I", "dH", sh), ("I", "padW", pw), ("I", "padH", ph)],
                   [])
    if isinstance(m, nn.Dropout):
        # initP (ctor) plus the DERIVED runtime fields updateOutput reads:
        # `private var p = initP`, inplace, scale — a stream without them
        # deserializes with JOS zero-defaults (p=0.0: dropout silently off)
        return obj("Dropout",
                   [("D", "initP", float(m.p)), ("D", "p", float(m.p)),
                    ("Z", "inplace", False), ("Z", "scale", True)], [])
    if isinstance(m, nn.SpatialCrossMapLRN):
        return obj("SpatialCrossMapLRN",
                   [("I", "size", m.size), ("D", "alpha", float(m.alpha)),
                    ("D", "beta", float(m.beta)), ("D", "k", float(m.k))],
                   [])
    if isinstance(m, nn.Threshold):
        return obj("Threshold",
                   [("D", "threshold", float(m.th)),
                    ("D", "value", float(m.v)),
                    ("Z", "inPlace", m.ip)], [])
    if isinstance(m, nn.Power):
        return obj("Power",
                   [("D", "power", float(m.power)),
                    ("D", "scale", float(m.scale)),
                    ("D", "shift", float(m.shift))], [])
    if isinstance(m, nn.Reshape):
        return obj("Reshape", [],
                   [("size", "[I", JavaArray(
                       dc.array("[I"), np.asarray(m.size, np.int32)))])
    simple = {nn.ReLU: "ReLU", nn.Tanh: "Tanh", nn.Sigmoid: "Sigmoid",
              nn.LogSoftMax: "LogSoftMax", nn.Identity: "Identity",
              nn.CMulTable: "CMulTable", nn.FlattenTable: "FlattenTable"}
    for pycls, short in simple.items():
        if isinstance(m, pycls):
            return obj(short, [], [])
    from . import bigdl_seq
    written = bigdl_seq.write_seq(dc, m, params, state, _w_module)
    if written is not None:
        return written
    raise ValueError(f"bigdl format save: unsupported layer "
                     f"{type(m).__name__}")


def save(model, path: str):
    """Write ``model`` (built) in the reference wire format."""
    from ..utils.convert import to_reference_tree
    if not model.built:
        raise ValueError("model has no parameters attached — call build() "
                         "or load weights first")
    params, state = to_reference_tree(model)
    dc = _DescCache()
    root = _w_module(dc, model, params, state)
    _fill_base_fields(root)  # inherited AbstractModule/field defaults
    w = JavaWriter()
    w.write_object(root)
    with open(path, "wb") as fh:
        fh.write(w.getvalue())
