"""TensorFlow GraphDef interop: load frozen graphs into the port's modules
and save modules out as GraphDefs.

Counterpart of ``bigdl_tpu/interop/tensorflow.py``: the same codec,
constant folding and op mapping; the runtime helper ops are port modules on
torch tensors (a folded constant stays a parameter leaf named ``"const"``,
so the trees match the JAX package's), the loader builds its ``Graph`` on
the device the caller names (the CUDA device by default; it raises without
one), and the saver reads a module's own leaves where it is given no
trees.

Reference: utils/tf/TensorflowLoader.scala:50 (parse :68, buildTFGraph :85,
buildBigDLModel :126) with the 1,216-LoC pattern-fusion table
TensorflowToBigDL.scala and the nn/tf helper ops (Const/Fill/Shape/
SplitAndSelect/StrideSlice, nn/tf/Const.scala:32), plus savers
utils/tf/{TensorflowSaver,BigDLToTensorflow}.scala — all over
protoc-generated GraphDef protos.

The design: instead of subgraph isomorphism against a fixed
pattern table, the loader (a) CONST-FOLDS every subgraph that depends only
on constants with numpy at load time — this subsumes the reference's
BatchNorm-folding patterns, whose rsqrt(var+eps)*gamma arithmetic is
entirely constant in a frozen graph — and (b) covers the remaining runtime
ops generically (elementwise ops with tensor or folded-constant operands,
Split with output slots, FusedBatchNorm, StridedSlice, Pad, Mean...), so
an unrolled LSTM/GRU cell imports as its raw op graph and computes
correctly without a cell-level pattern.  Unsupported ops FAIL LOUD by
default (round-1 advisor: silent Identity mapping produced wrong models);
pass permissive=True for the old behavior.

Field numbers (public tensorflow/core/framework/*.proto):
    GraphDef: node=1
    NodeDef: name=1, op=2, input=3 (repeated), device=4, attr=5 (map)
    map entry: key=1, value=2
    AttrValue: list=1, s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8
    TensorProto: dtype=1, tensor_shape=2, tensor_content=4,
        float_val=5, int_val=6
    TensorShapeProto: dim=2 (TensorShapeProto.Dim: size=1, name=2)
    AttrValue.ListValue: s=2, i=3, f=4, b=5, type=6, shape=7
    DataType: DT_FLOAT=1, DT_INT32=3
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from ..utils import pbwire
from ..utils.pbwire import Fields
from ..nn.module import Module

logger = logging.getLogger(__name__)

__all__ = ["TensorflowLoader", "TensorflowSaver", "load_tf", "save_tf"]

DT_FLOAT, DT_INT32 = 1, 3


def _base(ref: str) -> str:
    return ref.split(":")[0]


def _slot(ref: str) -> int:
    parts = ref.split(":")
    return int(parts[1]) if len(parts) > 1 else 0


class TFNode:
    def __init__(self, f: Fields):
        self.name = f.str(1)
        self.op = f.str(2)
        # keep output-slot suffixes ("node:1"); drop control deps ("^node")
        self.inputs = [i for i in f.strs(3) if not i.startswith("^")]
        self.attrs: Dict[str, Fields] = {}
        for entry in f.subs(5):
            self.attrs[entry.str(1)] = entry.sub(2)

    def attr_tensor(self) -> Optional[np.ndarray]:
        if "value" not in self.attrs:
            return None
        t = self.attrs["value"].sub(8)
        dtype = t.int(1)
        shape = tuple(d.int(1) for d in t.sub(2).subs(2))
        content = t.bytes(4)
        if content:
            np_dt = np.float32 if dtype == DT_FLOAT else np.int32
            arr = np.frombuffer(content, dtype=np_dt)
        elif dtype == DT_FLOAT:
            arr = np.array(t.floats(5), np.float32)
        else:
            arr = np.array(t.ints(6), np.int32)
        if shape and arr.size == int(np.prod(shape)):
            arr = arr.reshape(shape)
        elif shape and arr.size == 1:  # splat
            arr = np.full(shape, arr.ravel()[0])
        return arr

    def attr_ints(self, key: str) -> List[int]:
        if key not in self.attrs:
            return []
        return self.attrs[key].sub(1).ints(3)

    def attr_i(self, key: str, default: int = 0) -> int:
        return self.attrs[key].int(3, default) if key in self.attrs \
            else default

    def attr_f(self, key: str, default: float = 0.0) -> float:
        return self.attrs[key].float(4, default) if key in self.attrs \
            else default

    def attr_s(self, key: str) -> str:
        return self.attrs[key].bytes(2).decode() if key in self.attrs else ""

    def attr_b(self, key: str) -> bool:
        return bool(self.attrs[key].int(5)) if key in self.attrs else False


# --------------------------------------------------- runtime helper modules

import torch  # noqa: E402 (after numpy/pbwire for import cost)

_BINOPS = {"Add": torch.add, "AddV2": torch.add, "Sub": torch.sub,
           "Mul": torch.mul, "RealDiv": torch.div,
           "Maximum": torch.maximum, "Minimum": torch.minimum}


class _ConstBinary(Module):
    """x (op) folded-constant — plays nn/tf/Const.scala's role: the constant
    side of the op was folded from the frozen graph at load time."""

    def __init__(self, op_name: str, const, const_first: bool = False):
        super().__init__()
        self.op_name = op_name
        self._const = np.asarray(const)
        self.const_first = const_first

    def _init(self, generator):
        # float32, as the JAX package's jnp.asarray of a folded constant
        return {"const": torch.from_numpy(
            np.asarray(self._const, np.float32).copy())}

    def forward(self, x):
        c = self.const
        a, b = (c, x) if self.const_first else (x, c)
        return _BINOPS[self.op_name](a, b)


class _TFSplit(Module):
    """tf.split into `num` equal chunks along `axis` (the reference's
    SplitAndSelect helper); output is a table, consumers pick slots via
    SelectTable."""

    def __init__(self, axis: int, num: int):
        super().__init__()
        self.axis, self.num = axis, num

    def forward(self, x):
        if x.shape[self.axis] % self.num:
            raise ValueError(f"tf split: axis {self.axis} of size "
                             f"{x.shape[self.axis]} does not split into "
                             f"{self.num} equal chunks")
        return list(torch.chunk(x, self.num, dim=self.axis))


class _TFMean(Module):
    def __init__(self, axes, keepdims: bool):
        super().__init__()
        self.axes, self.keepdims = tuple(axes), keepdims

    def forward(self, x):
        return torch.mean(x, dim=self.axes, keepdim=self.keepdims)


class _TFPad(Module):
    def __init__(self, paddings):
        super().__init__()
        self.paddings = tuple(tuple(int(v) for v in row) for row in paddings)

    def forward(self, x):
        # torch's pad lists (before, after) from the last axis back
        flat = [v for row in reversed(self.paddings) for v in row]
        return torch.nn.functional.pad(x, flat)


class _TFStridedSlice(Module):
    """StridedSlice with constant begin/end/strides (the reference's
    StrideSlice helper, nn/tf/StrideSlice.scala)."""

    def __init__(self, begin, end, strides, begin_mask=0, end_mask=0,
                 shrink_axis_mask=0):
        super().__init__()
        self.begin = [int(v) for v in begin]
        self.end = [int(v) for v in end]
        self.strides = [int(v) for v in strides]
        self.begin_mask = begin_mask
        self.end_mask = end_mask
        self.shrink = shrink_axis_mask

    def forward(self, x):
        sl, shrink_axes = [], []
        for i in range(len(self.begin)):
            if self.shrink >> i & 1:
                sl.append(slice(self.begin[i], self.begin[i] + 1))
                shrink_axes.append(i)
                continue
            b = None if self.begin_mask >> i & 1 else self.begin[i]
            e = None if self.end_mask >> i & 1 else self.end[i]
            sl.append(_torch_slice(b, e, self.strides[i], x.shape[i]))
        y = x[tuple(sl) + (slice(None),) * (x.dim() - len(sl))]
        for ax in reversed(shrink_axes):
            y = torch.squeeze(y, dim=ax)
        return y


def _torch_slice(b, e, step, n):
    """numpy's ``slice(b, e, step)`` on an axis of size ``n`` as a torch
    index: torch takes no negative step, so one is resolved to the
    indices it selects."""
    if step > 0:
        return slice(b, e, step)
    return torch.tensor(range(n)[slice(b, e, step)], dtype=torch.long)


# numpy evaluators for load-time constant folding
_FOLD_UNARY = {"Rsqrt": lambda a: 1.0 / np.sqrt(a), "Sqrt": np.sqrt,
               "Square": np.square, "Neg": np.negative, "Exp": np.exp,
               "Log": np.log, "Abs": np.abs}


class TensorflowLoader:
    """Build a port Graph from a frozen GraphDef binary
    (reference: TensorflowLoader.load -> buildBigDLModel)."""

    def __init__(self, path: str, permissive: bool = False):
        with open(path, "rb") as f:
            buf = f.read()
        self.nodes = [TFNode(nf) for nf in Fields(buf).subs(1)]
        self.by_name = {n.name: n for n in self.nodes}
        self.permissive = permissive
        self._fold_memo: Dict[str, Optional[np.ndarray]] = {}

    # ------------------------------------------------ constant folding
    def resolve(self, ref: str) -> Optional[np.ndarray]:
        """Evaluate `ref` with numpy if it depends only on constants.
        Subsumes the reference's BatchNorm-folding patterns: the
        rsqrt(var+eps)*gamma chains of a frozen decomposed BN are pure
        constant arithmetic."""
        name = _base(ref)
        if name in self._fold_memo:
            return self._fold_memo[name]
        self._fold_memo[name] = None  # cycle guard
        node = self.by_name.get(name)
        val = None
        if node is not None:
            op = node.op
            ins = node.inputs
            if op == "Const":
                val = node.attr_tensor()
            elif op in ("Identity", "StopGradient", "CheckNumerics") and ins:
                val = self.resolve(ins[0])
            elif op in _FOLD_UNARY and ins:
                a = self.resolve(ins[0])
                val = _FOLD_UNARY[op](a) if a is not None else None
            elif op in _BINOPS and len(ins) == 2:
                a, b = self.resolve(ins[0]), self.resolve(ins[1])
                if a is not None and b is not None:
                    val = {"Add": np.add, "AddV2": np.add,
                           "Sub": np.subtract, "Mul": np.multiply,
                           "RealDiv": np.divide, "Maximum": np.maximum,
                           "Minimum": np.minimum}[op](a, b)
            elif op == "Reshape" and len(ins) == 2:
                a, shp = self.resolve(ins[0]), self.resolve(ins[1])
                if a is not None and shp is not None:
                    val = a.reshape([int(v) for v in np.ravel(shp)])
            elif op == "ExpandDims" and len(ins) == 2:
                a, ax = self.resolve(ins[0]), self.resolve(ins[1])
                if a is not None and ax is not None:
                    val = np.expand_dims(a, int(np.ravel(ax)[0]))
            elif op == "Squeeze" and ins:
                a = self.resolve(ins[0])
                if a is not None:
                    dims = node.attr_ints("squeeze_dims")
                    val = np.squeeze(a, tuple(dims) if dims else None)
            elif op == "Cast" and ins:
                a = self.resolve(ins[0])
                if a is not None:
                    dt = node.attr_i("DstT", DT_FLOAT)
                    val = a.astype(np.float32 if dt == DT_FLOAT
                                   else np.int32)
            elif op == "Fill" and len(ins) == 2:
                dims, v = self.resolve(ins[0]), self.resolve(ins[1])
                if dims is not None and v is not None:
                    val = np.full([int(d) for d in np.ravel(dims)],
                                  np.ravel(v)[0])
            elif op == "Pack" and ins:
                vals = [self.resolve(i) for i in ins]
                if all(v is not None for v in vals):
                    val = np.stack(vals, axis=node.attr_i("axis", 0))
            elif op == "ConcatV2" and len(ins) >= 2:
                vals = [self.resolve(i) for i in ins[:-1]]
                ax = self.resolve(ins[-1])
                if ax is not None and all(v is not None for v in vals):
                    val = np.concatenate(vals, int(np.ravel(ax)[0]))
        self._fold_memo[name] = val
        return val

    # ------------------------------------------------------- graph build
    def build(self, input_names: Optional[List[str]] = None,
              output_name: Optional[str] = None, device=None):
        """(Graph built on ``device``, default the CUDA device, its params
        tree with numpy leaves)."""
        from .. import nn
        from ..common import resolve_device
        from ..utils.convert import to_reference_tree
        from .caffe import _host_copy
        from ..nn.graph import Graph, Input

        tensors: Dict[tuple, object] = {}
        inputs: List = []
        params: List = []
        state_overrides: List = []
        modules: List = []
        consumed: set = set()
        multi_out = {}  # node name -> its table-producing graph node

        # mark BiasAdd fusions: conv/matmul -> biasadd
        bias_of: Dict[str, str] = {}
        for n in self.nodes:
            if n.op == "BiasAdd":
                prod = self.by_name.get(_base(n.inputs[0]))
                if prod and prod.op in ("Conv2D", "MatMul"):
                    bias_of[prod.name] = n.name
                    consumed.add(n.name)

        def node_out(ref):
            name, slot = _base(ref), _slot(ref)
            if (name, slot) in tensors:
                return tensors[(name, slot)]
            node = self.by_name.get(name)
            if node is None:
                raise KeyError(f"unknown tf node {name}")
            base = emit(node)
            if name in multi_out:
                sel = add_module(nn.SelectTable(slot), {},
                                 [multi_out[name]])
                tensors[(name, slot)] = sel
                return sel
            if slot != 0:
                raise ValueError(f"tf node {name} ({node.op}): output slot "
                                 f"{slot} unsupported")
            tensors[(name, 0)] = base
            return base

        def add_module(mod, p, bottoms, st=None):
            modules.append(mod)
            params.append(p)
            state_overrides.append(st)
            if len(bottoms) == 1:
                return mod(bottoms[0])
            return mod(bottoms)

        def binary(node):
            """Elementwise binary op with tensor or folded-const operands."""
            a_ref, b_ref = node.inputs[:2]
            ca, cb = self.resolve(a_ref), self.resolve(b_ref)
            if ca is not None and cb is None:
                return add_module(
                    _ConstBinary(node.op, ca, const_first=True), {},
                    [node_out(b_ref)])
            if cb is not None and ca is None:
                return add_module(_ConstBinary(node.op, cb), {},
                                  [node_out(a_ref)])
            table = {"Add": nn.CAddTable, "AddV2": nn.CAddTable,
                     "Sub": nn.CSubTable, "Mul": nn.CMulTable,
                     "RealDiv": nn.CDivTable, "Maximum": nn.CMaxTable,
                     "Minimum": nn.CMinTable}[node.op]
            return add_module(table(), {},
                              [node_out(a_ref), node_out(b_ref)])

        def emit(node):
            op = node.op
            if op in ("Placeholder", "PlaceholderV2"):
                inp = Input()
                inputs.append(inp)
                return inp
            if op in ("Identity", "StopGradient", "CheckNumerics", "NoOp"):
                return node_out(node.inputs[0])
            if op == "BiasAdd" and node.name in consumed:
                # fused into its Conv2D/MatMul producer
                return node_out(node.inputs[0])
            if op == "MatMul":
                w = self.resolve(node.inputs[1])
                if w is None:
                    raise ValueError(
                        f"MatMul {node.name}: weight input "
                        f"{node.inputs[1]!r} is not a constant — only "
                        "frozen graphs are supported (reference: "
                        "TensorflowLoader reads frozen GraphDefs)")
                if node.attr_b("transpose_a"):
                    raise ValueError(f"MatMul {node.name}: transpose_a "
                                     "unsupported")
                if node.attr_b("transpose_b"):
                    w = np.ascontiguousarray(w.T)
                bias = None
                if node.name in bias_of:
                    bias = self.resolve(
                        self.by_name[bias_of[node.name]].inputs[1])
                mod = nn.Linear(w.shape[0], w.shape[1],
                                with_bias=bias is not None)
                p = {"weight": np.ascontiguousarray(w.T)}
                if bias is not None:
                    p["bias"] = bias.reshape(-1)
                return add_module(mod, p, [node_out(node.inputs[0])])
            if op == "Conv2D":
                w = self.resolve(node.inputs[1])  # HWIO already (TF layout)
                if w is None:
                    raise ValueError(
                        f"Conv2D {node.name}: filter input "
                        f"{node.inputs[1]!r} is not a constant — only "
                        "frozen graphs are supported")
                bias = None
                if node.name in bias_of:
                    bias = self.resolve(
                        self.by_name[bias_of[node.name]].inputs[1])
                strides = node.attr_ints("strides") or [1, 1, 1, 1]
                kh, kw, cin, cout = w.shape
                same = node.attr_s("padding") == "SAME"
                mod = nn.SpatialConvolution(
                    cin, cout, kw, kh, strides[2], strides[1],
                    -1 if same else 0, -1 if same else 0,
                    with_bias=bias is not None)
                p = {"weight": w}
                if bias is not None:
                    p["bias"] = bias.reshape(-1)
                return add_module(mod, p, [node_out(node.inputs[0])])
            if op in ("FusedBatchNorm", "FusedBatchNormV2",
                      "FusedBatchNormV3"):
                gamma = self.resolve(node.inputs[1])
                beta = self.resolve(node.inputs[2])
                mean = self.resolve(node.inputs[3])
                var = self.resolve(node.inputs[4])
                if any(v is None for v in (gamma, beta, mean, var)):
                    raise ValueError(f"{op} {node.name}: non-constant "
                                     "scale/offset/moments")
                mod = nn.SpatialBatchNormalization(
                    int(gamma.shape[0]), eps=node.attr_f("epsilon", 1e-3),
                    affine=True)
                p = {"weight": gamma.reshape(-1), "bias": beta.reshape(-1)}
                st = {"running_mean": mean.reshape(-1),
                      "running_var": var.reshape(-1)}
                return add_module(mod, p, [node_out(node.inputs[0])], st)
            if op in ("MaxPool", "AvgPool"):
                k = node.attr_ints("ksize") or [1, 1, 1, 1]
                s = node.attr_ints("strides") or [1, 1, 1, 1]
                # SAME maps to our pad=-1 convention (TF divisor semantics
                # for AvgPool exclude padding -> count_include_pad=False)
                pad = -1 if node.attr_s("padding") == "SAME" else 0
                if op == "MaxPool":
                    mod = nn.SpatialMaxPooling(k[2], k[1], s[2], s[1],
                                               pad, pad)
                else:
                    mod = nn.SpatialAveragePooling(
                        k[2], k[1], s[2], s[1], pad, pad,
                        count_include_pad=False)
                return add_module(mod, {}, [node_out(node.inputs[0])])
            simple = {"Relu": nn.ReLU, "Relu6": nn.ReLU6, "Tanh": nn.Tanh,
                      "Sigmoid": nn.Sigmoid, "Softmax": nn.SoftMax,
                      "LogSoftmax": nn.LogSoftMax, "Softplus": nn.SoftPlus,
                      "Elu": nn.ELU, "Sqrt": nn.Sqrt, "Square": nn.Square,
                      "Exp": nn.Exp, "Abs": nn.Abs}
            if op in simple:
                return add_module(simple[op](), {},
                                  [node_out(node.inputs[0])])
            if op == "LeakyRelu":
                return add_module(nn.LeakyReLU(node.attr_f("alpha", 0.2)),
                                  {}, [node_out(node.inputs[0])])
            if op == "Rsqrt":
                return add_module(nn.Power(-0.5), {},
                                  [node_out(node.inputs[0])])
            if op == "Neg":
                return add_module(nn.MulConstant(-1.0), {},
                                  [node_out(node.inputs[0])])
            if op == "Reshape":
                shape = self.resolve(node.inputs[1])
                if shape is None:
                    raise ValueError(f"Reshape {node.name}: non-constant "
                                     "shape")
                size = tuple(int(v) for v in np.asarray(shape).ravel())
                size = tuple(0 if v == -1 and i == 0 else v
                             for i, v in enumerate(size))
                mod = nn.InferReshape(size)
                return add_module(mod, {}, [node_out(node.inputs[0])])
            if op == "Squeeze":
                dims = node.attr_ints("squeeze_dims")
                mod = nn.Squeeze(dims[0] if len(dims) == 1 else None)
                return add_module(mod, {}, [node_out(node.inputs[0])])
            if op == "Pad":
                paddings = self.resolve(node.inputs[1])
                if paddings is None:
                    raise ValueError(f"Pad {node.name}: non-constant "
                                     "paddings")
                return add_module(_TFPad(paddings), {},
                                  [node_out(node.inputs[0])])
            if op == "Mean":
                axes = self.resolve(node.inputs[1])
                if axes is None:
                    raise ValueError(f"Mean {node.name}: non-constant axes")
                mod = _TFMean([int(a) for a in np.ravel(axes)],
                              node.attr_b("keep_dims"))
                return add_module(mod, {}, [node_out(node.inputs[0])])
            if op == "StridedSlice":
                begin = self.resolve(node.inputs[1])
                end = self.resolve(node.inputs[2])
                strides = self.resolve(node.inputs[3])
                if any(v is None for v in (begin, end, strides)):
                    raise ValueError(f"StridedSlice {node.name}: "
                                     "non-constant begin/end/strides")
                if node.attr_i("ellipsis_mask") or \
                        node.attr_i("new_axis_mask"):
                    raise ValueError(f"StridedSlice {node.name}: ellipsis/"
                                     "new-axis masks unsupported")
                mod = _TFStridedSlice(
                    np.ravel(begin), np.ravel(end), np.ravel(strides),
                    node.attr_i("begin_mask"), node.attr_i("end_mask"),
                    node.attr_i("shrink_axis_mask"))
                return add_module(mod, {}, [node_out(node.inputs[0])])
            if op in ("Split", "SplitV"):
                if op == "Split":  # inputs: axis, value
                    axis = self.resolve(node.inputs[0])
                    value_ref = node.inputs[1]
                    num = node.attr_i("num_split")
                else:  # SplitV inputs: value, size_splits, axis
                    sizes = self.resolve(node.inputs[1])
                    if sizes is None or len(set(np.ravel(sizes))) != 1:
                        raise ValueError(f"SplitV {node.name}: only equal "
                                         "splits supported")
                    axis = self.resolve(node.inputs[2])
                    value_ref = node.inputs[0]
                    num = len(np.ravel(sizes))
                if axis is None:
                    raise ValueError(f"{op} {node.name}: non-constant axis")
                split = add_module(
                    _TFSplit(int(np.ravel(axis)[0]), int(num)), {},
                    [node_out(value_ref)])
                multi_out[node.name] = split
                return split
            if op in _BINOPS:
                return binary(node)
            if op == "ConcatV2":
                # last input is the axis (round-1 advisor: it was ignored);
                # TF frozen graphs and our runtime are both NHWC, so the
                # axis carries over directly
                ax = self.resolve(node.inputs[-1])
                if ax is None:
                    raise ValueError(f"ConcatV2 {node.name}: non-constant "
                                     "axis")
                return add_module(nn.JoinTable(int(np.ravel(ax)[0])), {},
                                  [node_out(i) for i in node.inputs[:-1]])
            if not self.permissive:
                raise ValueError(
                    f"tf op {op!r} ({node.name}) unsupported; pass "
                    "permissive=True to map it to Identity (reference "
                    "fails on unmatched patterns too, "
                    "TensorflowToBigDL.scala)")
            logger.warning("tf op %s (%s) unsupported; identity",
                           op, node.name)
            return add_module(nn.Identity(), {},
                              [node_out(node.inputs[0])])

        # choose the output: explicit, else last non-consumed non-const node
        if output_name is None:
            cands = [n for n in self.nodes
                     if n.op not in ("Const", "Identity", "NoOp")
                     and n.name not in consumed]
            output_name = cands[-1].name
        out_node = self.by_name[output_name]
        if out_node.op == "BiasAdd":  # fused into its producer
            output_name = out_node.inputs[0]
        out = node_out(output_name)

        graph = Graph(inputs if len(inputs) > 1 else inputs[0], out)
        graph.build(resolve_device(device), torch.Generator().manual_seed(0))
        init_params, init_state = to_reference_tree(graph, fetch=_host_copy)
        by_id = {id(m): (p, st) for m, p, st in
                 zip(modules, params, state_overrides)}
        for i, m in enumerate(graph.layers):
            loaded, st = by_id.get(id(m), (None, None))
            if loaded:
                for k, v in loaded.items():
                    want = np.asarray(init_params[i][k]).shape
                    if v.shape != want:
                        raise ValueError(
                            f"tf node param {k}: {v.shape} vs {want}")
                    init_params[i][k] = v.astype(
                        np.asarray(init_params[i][k]).dtype)
            if st:
                for k, v in st.items():
                    init_state[i][k] = v.astype(
                        np.asarray(init_state[i][k]).dtype)
        graph.attach(init_params, init_state)
        return graph, init_params


# ------------------------------------------------------------------ saving

def _tensor_proto(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = DT_FLOAT if arr.dtype.kind == "f" else DT_INT32
    arr = arr.astype(np.float32 if dt == DT_FLOAT else np.int32)
    shape = b"".join(
        pbwire.field_bytes(2, pbwire.field_varint(1, int(d)))
        for d in arr.shape)
    return (pbwire.field_varint(1, dt) +
            pbwire.field_bytes(2, shape) +
            pbwire.field_bytes(4, arr.tobytes()))


def _attr(key: str, value: bytes) -> bytes:
    return pbwire.field_bytes(
        5, pbwire.field_string(1, key) + pbwire.field_bytes(2, value))


def _node_def(name: str, op: str, inputs: List[str],
              attrs: Dict[str, bytes] = None) -> bytes:
    body = pbwire.field_string(1, name) + pbwire.field_string(2, op)
    for i in inputs:
        body += pbwire.field_string(3, i)
    for k, v in (attrs or {}).items():
        body += _attr(k, v)
    return pbwire.field_bytes(1, body)


def _const_node(name: str, arr: np.ndarray, dt: int = DT_FLOAT) -> bytes:
    return _node_def(name, "Const", [], {
        "dtype": pbwire.field_varint(6, dt),
        "value": pbwire.field_bytes(8, _tensor_proto(arr))})


def _t_attr(extra: Dict[str, bytes] = None) -> Dict[str, bytes]:
    """Required dtype attrs for float ops: real TF refuses to import a
    NodeDef missing a no-default attr like Conv2D's T (caught by the
    execute-in-tensorflow oracle, tests/test_interop.py)."""
    d = {"T": pbwire.field_varint(6, DT_FLOAT)}
    if extra:
        d.update(extra)
    return d


class TensorflowSaver:
    """Emit a frozen GraphDef for a Sequential of supported layers
    (reference: TensorflowSaver/BigDLToTensorflow.scala)."""

    @classmethod
    def save(cls, model, params, path: str, state=None):
        """``params`` or ``state`` None: the module's own
        (``to_reference_tree``)."""
        from .. import nn
        from .caffe import _own_trees

        params, state = _own_trees(model, params, state)
        out = bytearray()
        out += _node_def("input", "Placeholder", [],
                         {"dtype": pbwire.field_varint(6, DT_FLOAT)})
        prev = "input"
        flat = _flatten_seq(model, params, state)
        for i, (mod, p, s) in enumerate(flat):
            name = f"{type(mod).__name__.lower()}_{i}"
            if isinstance(mod, nn.Linear):
                wname, bname = name + "/weight", name + "/bias"
                out += _const_node(wname,
                                   np.asarray(p["weight"], np.float32).T)
                out += _node_def(name, "MatMul", [prev, wname], _t_attr())
                prev = name
                if "bias" in p:
                    out += _const_node(bname,
                                       np.asarray(p["bias"], np.float32))
                    out += _node_def(name + "/badd", "BiasAdd",
                                     [name, bname], _t_attr())
                    prev = name + "/badd"
            elif isinstance(mod, nn.SpatialConvolution):
                wname = name + "/weight"
                out += _const_node(wname, np.asarray(p["weight"],
                                                     np.float32))
                sh, sw = mod.stride
                strides = pbwire.field_bytes(
                    1, pbwire.field_packed_varints(3, [1, sh, sw, 1]))
                # TF only has SAME/VALID; explicit symmetric half-kernel
                # padding at stride 1 is exactly SAME
                kh, kw = mod.kernel
                ph, pw = mod.pad
                if ph == -1 or pw == -1 or (
                        (sh, sw) == (1, 1) and (ph, pw) == (kh // 2, kw // 2)
                        and kh % 2 == 1 and kw % 2 == 1):
                    pad = b"SAME"
                elif (ph, pw) == (0, 0):
                    pad = b"VALID"
                else:
                    raise ValueError(
                        f"TensorflowSaver: conv padding {mod.pad} with "
                        f"stride {mod.stride} has no SAME/VALID equivalent")
                out += _node_def(name, "Conv2D", [prev, wname], _t_attr({
                    "strides": strides,
                    "padding": pbwire.field_bytes(2, pad)}))
                prev = name
                if "bias" in p:
                    bname = name + "/bias"
                    out += _const_node(bname,
                                       np.asarray(p["bias"], np.float32))
                    out += _node_def(name + "/badd", "BiasAdd",
                                     [name, bname], _t_attr())
                    prev = name + "/badd"
            elif isinstance(mod, nn.BatchNormalization):
                if s is None:
                    raise ValueError("TensorflowSaver: BatchNormalization "
                                     "needs running stats (pass state=)")
                c = mod.n_output
                gamma = (np.asarray(p["weight"], np.float32) if mod.affine
                         else np.ones(c, np.float32))
                beta = (np.asarray(p["bias"], np.float32) if mod.affine
                        else np.zeros(c, np.float32))
                out += _const_node(name + "/gamma", gamma)
                out += _const_node(name + "/beta", beta)
                out += _const_node(name + "/mean",
                                   np.asarray(s["running_mean"], np.float32))
                out += _const_node(name + "/var",
                                   np.asarray(s["running_var"], np.float32))
                out += _node_def(name, "FusedBatchNormV3",
                                 [prev, name + "/gamma", name + "/beta",
                                  name + "/mean", name + "/var"],
                                 _t_attr({
                                     "U": pbwire.field_varint(6, DT_FLOAT),
                                     "epsilon": pbwire.field_float(
                                         4, mod.eps),
                                     "is_training": pbwire.field_varint(
                                         5, 0)}))
                prev = name
            elif isinstance(mod, nn.ReLU):
                out += _node_def(name, "Relu", [prev], _t_attr())
                prev = name
            elif isinstance(mod, nn.Tanh):
                out += _node_def(name, "Tanh", [prev], _t_attr())
                prev = name
            elif isinstance(mod, nn.Sigmoid):
                out += _node_def(name, "Sigmoid", [prev], _t_attr())
                prev = name
            elif isinstance(mod, nn.LogSoftMax):
                out += _node_def(name, "LogSoftmax", [prev], _t_attr())
                prev = name
            elif isinstance(mod, (nn.SoftMax,)):
                out += _node_def(name, "Softmax", [prev], _t_attr())
                prev = name
            elif isinstance(mod, nn.Dropout):
                pass  # inference graph: dropout is identity when frozen
            elif isinstance(mod, (nn.SpatialMaxPooling,
                                  nn.SpatialAveragePooling)):
                kh, kw = mod.kernel
                sh, sw = mod.stride
                pad = b"SAME" if -1 in mod.pad else b"VALID"
                op_name = ("MaxPool" if isinstance(mod, nn.SpatialMaxPooling)
                           else "AvgPool")
                out += _node_def(name, op_name, [prev], _t_attr({
                    "ksize": pbwire.field_bytes(
                        1, pbwire.field_packed_varints(3, [1, kh, kw, 1])),
                    "strides": pbwire.field_bytes(
                        1, pbwire.field_packed_varints(3, [1, sh, sw, 1])),
                    "padding": pbwire.field_bytes(2, pad)}))
                prev = name
            elif isinstance(mod, (nn.Reshape, nn.InferReshape, nn.View)):
                # our Reshape sizes are per-sample; TF shapes carry the
                # batch dim, so prepend -1 (loader maps it back to a
                # copy-batch-dim 0)
                shp = getattr(mod, "size", (-1,))
                sname = name + "/shape"
                out += _const_node(sname, np.array(
                    [-1] + [int(s_) for s_ in shp], np.int32), DT_INT32)
                out += _node_def(name, "Reshape", [prev, sname], _t_attr(
                    {"Tshape": pbwire.field_varint(6, DT_INT32)}))
                prev = name
            else:
                raise ValueError(
                    f"TensorflowSaver: unsupported {type(mod).__name__}")
        with open(path, "wb") as f:
            f.write(out)
        return path


def _flatten_seq(model, params, state=None):
    from ..nn.containers import Sequential
    from ..nn.graph import Graph, _InputModule

    def rec(mod, p, s, acc):
        if isinstance(mod, Sequential):
            for i, m in enumerate(mod.layers):
                rec(m, p[i], s[i] if s is not None else None, acc)
        elif isinstance(mod, _InputModule):
            pass
        else:
            acc.append((mod, p, s))

    acc = []
    if isinstance(model, Graph):
        for i, m in enumerate(model.layers):
            if not isinstance(m, _InputModule):
                acc.append((m, params[i],
                            state[i] if state is not None else None))
        return acc
    rec(model, params, state, acc)
    return acc


def load_tf(path: str, inputs=None, outputs=None, permissive: bool = False,
            device=None):
    """(reference: Module.loadTF, nn/Module.scala:63): (Graph built on
    ``device``, its params tree)."""
    return TensorflowLoader(path, permissive=permissive).build(
        inputs, outputs, device)


def save_tf(model, params, path: str, state=None):
    """(reference: Module.saveTF)."""
    return TensorflowSaver.save(model, params, path, state=state)
