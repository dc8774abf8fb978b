"""BigDL native-format support for the sequence/embedding zoo.

Counterpart of ``bigdl_tpu/interop/bigdl_seq.py``; the activations an
``RnnCell`` carries are the port's own (``torch.tanh``, ``torch.sigmoid``,
``torch.relu``), the functions ``nn/recurrent.py``'s cells take.  The
reference serializes *every* module
automatically (JVM object serialization needs no per-class code,
nn/Module.scala:41-43), so its RNN and text-classification models —
`Recurrent(RnnCell|LSTM|GRU)`, `TimeDistributed`, `LookupTable`,
`TemporalConvolution`, and `Graph` DAGs — roundtrip out of the box.  This
module closes that gap for `interop/bigdl.py`'s name-based mapper.

The interesting part is weight RE-HOMING.  The reference builds its cells
out of sub-modules (nn/RNN.scala:46-80, nn/LSTM.scala:74-184,
nn/GRU.scala:79-180): the input half of every gate projection lives in a
`preTopology = TimeDistributed(Linear(in, G*hidden))` hoisted out of the
recurrence, and the hidden half in `Linear` layers buried inside the
cell's Sequential graph.  The port (like the JAX package) fuses both
halves into single kernels (nn/recurrent.py), so load/save split/merge:

  RnnCell   ref i2h Linear(H,I) + h2h Linear(H,H)  <->  w_ih/w_hh/bias
            (bias = i2h.b + h2h.b — identical forward, one fused add)
  LSTM p=0  ref gate order [i, g, f, o] (LSTM.scala:124-133 comment
            "input, hidden, forget, output")  <->  ours [i, f, g, o] in
            one (I+H, 4H) kernel — chunks permuted on the way through
  GRU p=0   ref h' = (1-z)*cand + z*h (GRU.scala:155-172); ours
            h' = (1-u)*h + u*cand, i.e. u = 1-z — so the update-gate
            weights are NEGATED (sigmoid(-x) = 1-sigmoid(x)): exact, not
            approximate
  Temporal  ref weight (out, kw*in), window flattened frame-major
            (TemporalConvolution.scala:160-166)  <->  ours (kw, in, out)
  Graph     utils/DirectedGraph.scala Node objects (element/nexts/prevs,
            a CYCLIC object graph — handle sharing in javaser covers it)

The `p != 0` cell variants restructure the reference graph entirely
(per-gate Dropout+Linear stacks, no preTopology) and fail loudly.

Saving rebuilds the reference's *actual* internal cell topology (the
Sequential/ParallelTable/SelectTable machine from buildLSTM/buildGRU), so
a JVM deserializing the stream gets a structurally faithful, runnable
module graph, with real @SerialVersionUIDs where the reference declares
them (classes without the annotation get the JVM's computed default,
which cannot be derived without a JVM — see _SUID in bigdl.py).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np

from .javaser import JavaArray, JavaObject

_PKG = "com.intel.analytics.bigdl.nn."
_NODE = "com.intel.analytics.bigdl.utils.Node"
_T = "Lcom/intel/analytics/bigdl/tensor/Tensor;"
_MODULE_SIG = "Lcom/intel/analytics/bigdl/nn/abstractnn/AbstractModule;"
_BUF_SIG = "Lscala/collection/mutable/ArrayBuffer;"


def _short(classname: str) -> str:
    return classname[len(_PKG):] if classname.startswith(_PKG) else classname


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _walk(obj, seen=None):
    """DFS over a JavaObject graph in field order (cycle-safe)."""
    if seen is None:
        seen = set()
    if not isinstance(obj, (JavaObject, JavaArray)) or id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    if isinstance(obj, JavaArray):
        vals = list(obj.values) if obj.values is not None else []
        for v in vals:
            yield from _walk(v, seen)
        return
    for v in obj.fields.values():
        yield from _walk(v, seen)
    for anns in obj.annotations.values():
        for a in anns:
            yield from _walk(a, seen)


def _find_linears(obj) -> List[JavaObject]:
    return [o for o in _walk(obj)
            if isinstance(o, JavaObject) and o.classname == _PKG + "Linear"]


def _seq_items(v) -> list:
    """Items of a serialized scala sequence (ArrayBuffer / plain array /
    WrappedArray).  None and plain (possibly empty) Python sequences mean
    "no elements" — callers pass `fields.get("nexts", [])`, and a Node
    with a null/absent successor buffer must read as a leaf, not as an
    'unsupported scala sequence encoding' error."""
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [x for x in v if x is not None]
    if isinstance(v, JavaArray):
        return [x for x in v.values if x is not None]
    if isinstance(v, JavaObject):
        f = v.fields
        if "array" in f:  # ArrayBuffer / WrappedArray$ofRef
            arr = f["array"]
            n = int(f.get("size0", len(arr.values)))
            return [x for x in list(arr.values)[:n] if x is not None]
    raise ValueError(
        f"bigdl format: unsupported scala sequence encoding {v!r:.80}")


_ACT_BY_NAME: dict = {}
_NAME_BY_ACT: dict = {}


def _init_act_maps():
    if _ACT_BY_NAME:
        return
    import torch
    _ACT_BY_NAME.update({"Tanh": torch.tanh, "Sigmoid": torch.sigmoid,
                         "ReLU": torch.relu})
    _NAME_BY_ACT.update({id(v): k for k, v in _ACT_BY_NAME.items()})


def build_seq(short: str, obj: JavaObject, build: Callable):
    """Reader dispatch for the sequence zoo; None = class not handled here.
    `build` is interop.bigdl._build (recursion into generic layers)."""
    from .. import nn
    from .bigdl import _children, _to_numpy

    f = obj.fields
    if short == "TimeDistributed":
        m, p, s = build(f["layer"])
        return nn.TimeDistributed(m), [p], [s]

    if short == "LookupTable":
        max_norm = f.get("maxNorm")
        max_norm = (None if max_norm is None
                    or max_norm >= np.finfo(np.float64).max else
                    float(max_norm))
        pad = float(f.get("paddingValue", 0.0))
        m = nn.LookupTable(int(f["nIndex"]), int(f["nOutput"]),
                           padding_value=pad if pad > 0 else None,
                           max_norm=max_norm,
                           norm_type=float(f.get("normType", 2.0)),
                           one_based=True)  # reference indices are 1-based
        return m, {"weight": _to_numpy(f["weight"])}, {}

    if short == "TemporalConvolution":
        m = nn.TemporalConvolution(int(f["inputFrameSize"]),
                                   int(f["outputFrameSize"]),
                                   int(f["kernelW"]),
                                   int(f.get("strideW", 1)))
        w = _to_numpy(f["weight"])  # (out, kw*in), window frame-major
        kw, cin = m.kernel_w, m.input_frame_size
        w = w.reshape(w.shape[0], kw, cin).transpose(1, 2, 0)  # (kw, in, out)
        return m, {"weight": w, "bias": _to_numpy(f["bias"])}, {}

    if short == "Recurrent":
        return _build_recurrent(obj, build)

    if short == "BiRecurrent":
        return _build_birecurrent(obj, build)

    if short == "Graph":
        return _build_graph(obj, build)

    if short == "BinaryTreeLSTM":
        return _build_treelstm(obj, build)

    return None


def _ref_linear_wb(lin: JavaObject):
    from .bigdl import _to_numpy

    w = _to_numpy(lin.fields["weight"])  # (out, in)
    b = (_to_numpy(lin.fields["bias"])
         if lin.fields.get("bias") is not None else None)
    return w, b


def _build_recurrent(obj: JavaObject, build):
    from .. import nn
    from .bigdl import _children, _to_numpy

    _init_act_maps()
    kids = _children(obj)
    if len(kids) != 2:
        raise ValueError(
            "bigdl format: Recurrent without a hoisted preTopology "
            f"({len(kids)} children) — the p!=0 dropout cell variants "
            "restructure the reference graph and are not mapped")
    pre, topo = kids
    if _short(pre.classname) == "Sequential":
        # LSTMPeephole wraps its preTopology as Sequential(Dropout, TD)
        # (LSTMPeephole.scala:71-75).  Only inference-identity Dropout
        # siblings may be discarded — any other module would change the
        # forward, so unwrapping it silently would mis-load the stream.
        kids_pre = _children(pre)
        tds = [c for c in kids_pre
               if _short(c.classname) == "TimeDistributed"]
        others = [c for c in kids_pre
                  if _short(c.classname) not in ("TimeDistributed",
                                                 "Dropout")]
        if len(tds) == 1 and not others:
            pre = tds[0]
    if _short(pre.classname) != "TimeDistributed":
        raise ValueError(f"bigdl format: Recurrent preTopology "
                         f"{pre.classname} not supported")
    wi, bi = _ref_linear_wb(pre.fields["layer"])
    tshort = _short(topo.classname)
    tf = topo.fields

    if tshort == "RnnCell":
        wh, bh = _ref_linear_wb(tf["h2h"])
        hidden = wh.shape[0]
        cell_modules = _children(tf["cell"])
        act_name = _short(cell_modules[2].classname)
        if act_name not in _ACT_BY_NAME:
            raise ValueError(f"bigdl format: RnnCell activation {act_name} "
                             "not mapped")
        cell = nn.RnnCell(wi.shape[1], hidden, _ACT_BY_NAME[act_name])
        bias = (bi if bi is not None else 0.0) + \
               (bh if bh is not None else 0.0)
        p = {"w_ih": wi.T.copy(), "w_hh": wh.T.copy(),
             "bias": np.asarray(bias, np.float32)}
    elif tshort == "LSTM":
        if float(tf.get("p", 0.0)) != 0.0:
            raise ValueError("bigdl format: LSTM with p!=0 uses the "
                             "per-gate dropout graph — not mapped")
        hidden = int(tf["hiddenSize"])
        insize = int(tf["inputSize"])
        [h2g] = _find_linears(tf["cell"])
        wh, _ = _ref_linear_wb(h2g)          # (4H, H), no bias
        # ref chunk rows [i, g, f, o] -> ours columns [i, f, g, o]
        perm = _gate_perm_ref_to_ours(hidden)
        cell = nn.LSTM(insize, hidden)
        kernel = np.concatenate([wi[perm].T, wh[perm].T], axis=0)
        p = {"kernel": kernel.copy(),
             "bias": np.asarray(bi[perm], np.float32)}
    elif tshort == "GRU":
        if float(tf.get("p", 0.0)) != 0.0:
            raise ValueError("bigdl format: GRU with p!=0 uses the "
                             "per-gate dropout graph — not mapped")
        out = int(tf["outputSize"])
        insize = int(tf["inputSize"])
        linears = _find_linears(tf["cell"])
        h2g = next(l for l in linears
                   if int(l.fields["outputSize"]) == 2 * out)
        hhat = next(l for l in linears
                    if int(l.fields["outputSize"]) == out)
        wh2g, _ = _ref_linear_wb(h2g)        # (2O, O) rows [r, z]
        whh, _ = _ref_linear_wb(hhat)        # (O, O)
        cell = nn.GRU(insize, out)
        # u = 1 - z  =>  negate the z rows (sigmoid(-x) = 1 - sigmoid(x))
        gate_i = np.concatenate([wi[:out], -wi[out:2 * out]], axis=0)
        gate_h = np.concatenate([wh2g[:out], -wh2g[out:]], axis=0)
        p = {"gate_kernel": np.concatenate([gate_i.T, gate_h.T], axis=0),
             "gate_bias": np.concatenate([bi[:out], -bi[out:2 * out]]),
             "cand_kernel": np.concatenate([wi[2 * out:].T, whh.T], axis=0),
             "cand_bias": np.asarray(bi[2 * out:], np.float32)}
    elif tshort == "LSTMPeephole":
        if float(tf.get("p", 0.0)) != 0.0:
            raise ValueError("bigdl format: LSTMPeephole with p!=0 is not "
                             "mapped")
        hidden = int(tf["hiddenSize"])
        insize = int(tf["inputSize"])
        # gate identity comes from each gate ParallelTable's Narrow offset
        # (buildGate/buildHidden, LSTMPeephole.scala:77-130): offset 1=i,
        # 1+H=f, 1+2H=g (hidden, no peephole), 1+3H=o — wire chunk order
        # [i, f, g, o], the SAME as this framework's kernel, no permute
        wh = {}
        peep = {}
        for pt in (o for o in _walk(tf["cell"])
                   if isinstance(o, JavaObject)
                   and o.classname == _PKG + "ParallelTable"):
            members = _children(pt)
            narrows = [c for c in members
                       if _short(c.classname) == "Narrow"]
            if len(narrows) != 1:
                continue
            chunk = (int(narrows[0].fields["offset"]) - 1) // hidden
            [lin] = _find_linears(pt)
            wh[chunk], _ = _ref_linear_wb(lin)
            cmuls = [c for c in _walk(pt)
                     if isinstance(c, JavaObject)
                     and c.classname == _PKG + "CMul"]
            if cmuls:
                peep[chunk] = _to_numpy(
                    cmuls[0].fields["weight"]).reshape(-1)
        if sorted(wh) != [0, 1, 2, 3] or sorted(peep) != [0, 1, 3]:
            raise ValueError(
                f"bigdl format: LSTMPeephole cell structure not recognized "
                f"(gates {sorted(wh)}, peepholes {sorted(peep)})")
        cell = nn.LSTMPeephole(insize, hidden)
        kernel = np.concatenate(
            [wi.T] + [np.concatenate([wh[c].T for c in range(4)], axis=1)],
            axis=0)
        p = {"kernel": kernel, "bias": np.asarray(bi, np.float32),
             "peep_i": peep[0], "peep_f": peep[1], "peep_o": peep[3]}
    else:
        raise ValueError(f"bigdl format: Recurrent cell {tshort} not "
                         "mapped (RnnCell/LSTM/GRU/LSTMPeephole only)")
    # the cell object is built here, not via _build dispatch, so its
    # AbstractModule grad scales are re-applied here too
    for attr, key in (("scale_w", "scaleW"), ("scale_b", "scaleB")):
        v = tf.get(key)
        if v is not None and float(v) != 1.0:
            setattr(cell, attr, float(v))
    return nn.Recurrent(cell), [p], [{}]


def _build_birecurrent(obj: JavaObject, build):
    """BiRecurrent.scala:33 — `layer`/`revLayer` Recurrents (revLayer holds
    a CLONED cell with independent weights) merged by the last module of
    the internal `birnn` Sequential (CAddTable default, JoinTable for
    concat)."""
    from .. import nn
    from .bigdl import _children

    fwd_m, fwd_p, fwd_s = build(obj.fields["layer"])
    rev_m, rev_p, rev_s = build(obj.fields["revLayer"])
    merge_obj = _children(obj.fields["birnn"])[-1]
    mshort = _short(merge_obj.classname)
    if mshort == "CAddTable":
        merge = "sum"
    elif mshort == "JoinTable":
        dim = int(merge_obj.fields.get("dimension", 3))
        if dim != 3:  # (batch, time, feature) 1-based: features only
            raise ValueError(
                f"bigdl format: BiRecurrent JoinTable merge over dim {dim} "
                "has no mapping here (feature concat, dim=3, only)")
        merge = "concat"
    else:
        raise ValueError(f"bigdl format: BiRecurrent merge {mshort} not "
                         "mapped (CAddTable/JoinTable only)")
    bi = nn.BiRecurrent(fwd_m.layers[0], merge)
    bi.layers[0] = fwd_m   # keep the two loaded Recurrents verbatim
    bi.layers[1] = rev_m   # (revLayer's weights are independent)
    return bi, [fwd_p, rev_p], [fwd_s, rev_s]


def _gate_perm_ref_to_ours(h: int) -> np.ndarray:
    """Row permutation taking the reference's [i, g, f, o] gate chunks to
    this framework's [i, f, g, o] (involution — also ours -> ref)."""
    idx = np.arange(4 * h)
    return np.concatenate([idx[0:h], idx[2 * h:3 * h],
                           idx[h:2 * h], idx[3 * h:4 * h]])


def _build_graph(obj: JavaObject, build):
    from .. import nn

    inputs = _seq_items(obj.fields["inputs"])
    outputs = _seq_items(obj.fields["outputs"])
    built: dict = {}   # id(java Node) -> (ModuleNode, params, state)

    def get_node(jn: JavaObject):
        if id(jn) in built:
            return built[id(jn)]
        if jn.classname != _NODE:
            raise ValueError(f"bigdl format: Graph expected Node, got "
                             f"{jn.classname}")
        elem = jn.fields["element"]
        if _short(elem.classname) == "Input":
            mn = nn.Input()
            entry = (mn, {}, {})
        else:
            m, p, s = build(elem)
            mn = nn.ModuleNode(m)
            entry = (mn, p, s)
        built[id(jn)] = entry
        for nxt in _seq_items(jn.fields.get("nexts", [])):
            mn.point_to(get_node(nxt)[0])
        return entry

    for jn in list(inputs) + list(outputs):
        get_node(jn)
    g = nn.Graph([built[id(j)][0] for j in inputs],
                 [built[id(j)][0] for j in outputs])
    by_mod = {id(mn.element): (p, s) for (mn, p, s) in built.values()}
    params = [by_mod[id(m)][0] for m in g.layers]
    states = [by_mod[id(m)][1] for m in g.layers]
    return g, params, states


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _obj(dc, short, prims, objs) -> JavaObject:
    """Same shape helper as bigdl._w_module's local obj()."""
    name = short if "." in short else _PKG + short
    fields = ([(t, n, None) for t, n, _v in prims] +
              [("L" if not s.startswith("[") else "[", n, s)
               for n, s, _v in objs])
    cd = dc.get(name, fields)
    vals = {n: v for _t, n, v in prims}
    vals.update({n: v for n, _s, v in objs})
    return JavaObject(cd, vals)


def _buffer(dc, items) -> JavaObject:
    from .bigdl import _w_buffer
    return _w_buffer(dc, items)


_OBJ_SIG = "Ljava/lang/Object;"


def _boxed_float(dc, v: float) -> JavaObject:
    """A java.lang.Float box — the erased value of a Scala `val x: T`
    field under TensorNumeric[Float].  Real JDK SUIDs (spec constants), so
    an actual ObjectInputStream resolves the boxes."""
    num_cd = dc.get("java.lang.Number", [])
    cd = dc.get("java.lang.Float", [("F", "value", None)],
                super_desc=num_cd)
    return JavaObject(cd, {"value": float(v)})


def _dropout(dc, init_p: float) -> JavaObject:
    """Dropout with the DERIVED runtime field the JVM's updateOutput reads
    (`private var p = initP`) — a stream carrying only initP deserializes
    with p = 0.0 (JOS missing-field default) and drops nothing/everything
    wrongly on a real BigDL."""
    return _obj(dc, "Dropout",
                [("D", "initP", float(init_p)), ("D", "p", float(init_p)),
                 ("Z", "inplace", False), ("Z", "scale", True)], [])


def _mul_constant(dc, v: float) -> JavaObject:
    # `scalar` is a derived non-transient val (ev.fromType(constant)) the
    # reference's updateOutput multiplies by — omit it and a JVM load
    # computes with scalar = null (NPE) despite a well-formed stream
    return _obj(dc, "MulConstant",
                [("D", "constant", float(v)), ("Z", "inplace", False)],
                [("scalar", _OBJ_SIG, _boxed_float(dc, v))])


def _add_constant(dc, v: float) -> JavaObject:
    return _obj(dc, "AddConstant",
                [("D", "constant_scalar", float(v)),
                 ("Z", "inplace", False)],
                [("scalar", _OBJ_SIG, _boxed_float(dc, v))])


def _container(dc, short, children, extra_prims=(), extra_objs=()) \
        -> JavaObject:
    # `modules` is declared on the Container SUPER desc (attached by
    # _DescCache automatically) — only class-own fields go on this desc;
    # the value is written under Container's classdata
    o = _obj(dc, short, list(extra_prims), list(extra_objs))
    o.fields["modules"] = _buffer(dc, children)
    return o


def _seq(dc, *children) -> JavaObject:
    return _container(dc, "Sequential", list(children))


def _concat_table(dc, *children) -> JavaObject:
    return _container(dc, "ConcatTable", list(children))


def _parallel_table(dc, *children) -> JavaObject:
    return _container(dc, "ParallelTable", list(children))


def _simple(dc, short) -> JavaObject:
    return _obj(dc, short, [], [])


def _select(dc, i) -> JavaObject:
    return _obj(dc, "SelectTable", [("I", "index", i)], [])


def _narrow_table(dc, offset, length) -> JavaObject:
    return _obj(dc, "NarrowTable",
                [("I", "offset", offset), ("I", "length", length),
                 ("I", "len", length)], [])


def _cadd(dc, inplace) -> JavaObject:
    return _obj(dc, "CAddTable", [("Z", "inplace", inplace)], [])


def _reshape(dc, sizes) -> JavaObject:
    return _obj(dc, "Reshape", [],
                [("size", "[I", JavaArray(dc.array("[I"),
                                          np.asarray(sizes, np.int32)))])


def _split_table(dc, dim, n_input_dims) -> JavaObject:
    return _obj(dc, "SplitTable",
                [("I", "dimension", dim), ("I", "nInputDims", n_input_dims)],
                [])


def _linear(dc, w_out_in, bias) -> JavaObject:
    from .bigdl import _w_tensor

    out_size, in_size = w_out_in.shape
    return _obj(dc, "Linear",
                [("I", "inputSize", in_size), ("I", "outputSize", out_size),
                 ("Z", "withBias", bias is not None)],
                [("weight", _T, _w_tensor(dc, w_out_in)),
                 ("bias", _T, _w_tensor(dc, bias)
                  if bias is not None else None)])


def _time_distributed(dc, inner) -> JavaObject:
    return _obj(dc, "TimeDistributed", [], [("layer", _MODULE_SIG, inner)])


def _hiddens_shape(dc, sizes) -> JavaArray:
    return JavaArray(dc.array("[I"), np.asarray(sizes, np.int32))


def write_seq(dc, m, params, state, w_module):
    """Writer dispatch for the sequence zoo; None = class not handled here.
    `w_module` is interop.bigdl._w_module (recursion)."""
    from .. import nn
    from ..nn.graph import _InputModule

    _init_act_maps()
    from .bigdl import _scales

    def stamped(o):
        o.fields.update(_scales(m))  # layer-wise grad scale survives
        return o

    if isinstance(m, nn.TimeDistributed):
        return stamped(_time_distributed(
            dc, w_module(dc, m.layers[0], params[0], state[0])))

    if isinstance(m, nn.LookupTable):
        if not m.one_based:
            raise ValueError(
                "bigdl format save: LookupTable(one_based=False) has no "
                "reference equivalent (reference indices are 1-based)")
        from .bigdl import _w_tensor
        big = np.finfo(np.float64).max
        return stamped(_obj(dc, "LookupTable",
                    [("I", "nIndex", m.n_index), ("I", "nOutput", m.n_output),
                     ("D", "paddingValue", float(m.padding_value or 0.0)),
                     ("D", "maxNorm", float(m.max_norm)
                      if m.max_norm is not None else big),
                     ("D", "normType", float(m.norm_type))],
                    [("weight", _T, _w_tensor(dc, params["weight"]))]))

    if isinstance(m, nn.TemporalConvolution):
        from .bigdl import _w_tensor
        w = np.asarray(params["weight"])           # (kw, in, out)
        w2 = w.transpose(2, 0, 1).reshape(m.output_frame_size, -1)
        return stamped(_obj(dc, "TemporalConvolution",
                    [("I", "inputFrameSize", m.input_frame_size),
                     ("I", "outputFrameSize", m.output_frame_size),
                     ("I", "kernelW", m.kernel_w),
                     ("I", "strideW", m.stride_w),
                     ("Z", "propagateBack", True)],
                    [("weight", _T, _w_tensor(dc, w2)),
                     ("bias", _T, _w_tensor(dc, params["bias"]))]))

    if isinstance(m, nn.BiRecurrent):
        layer = _write_recurrent(dc, m.layers[0], params[0], state[0])
        rev = _write_recurrent(dc, m.layers[1], params[1], state[1])
        if m.merge == "concat":
            # (batch, time, feature) 1-based: feature dim 3
            merge_obj = _obj(dc, "JoinTable",
                             [("I", "dimension", 3),
                              ("I", "nInputDims", 0)], [])
        else:
            merge_obj = _cadd(dc, True)
        rev_wrap = _seq(dc, _obj(dc, "Reverse", [("I", "dimension", 2)], []),
                        rev,
                        _obj(dc, "Reverse", [("I", "dimension", 2)], []))
        birnn = _seq(
            dc,
            _concat_table(dc, _simple(dc, "Identity"),
                          _simple(dc, "Identity")),
            _parallel_table(dc, layer, rev_wrap),
            merge_obj)
        # the reference's own modules buffer stays EMPTY (its add()
        # delegates to layer/revLayer; BiRecurrent.scala:52-57)
        return stamped(_container(dc, "BiRecurrent", [], (
            ("I", "timeDim", 2),),
            [("layer", _MODULE_SIG, layer),
             ("revLayer", _MODULE_SIG, rev),
             ("birnn", _MODULE_SIG, birnn)]))

    if isinstance(m, nn.Recurrent):
        return stamped(_write_recurrent(dc, m, params, state))

    if isinstance(m, nn.Graph):
        return stamped(_write_graph(dc, m, params, state, w_module))

    if isinstance(m, nn.BinaryTreeLSTM):
        return stamped(_write_treelstm(dc, m, params, w_module))

    if isinstance(m, _InputModule):
        return _simple(dc, "Input")

    return None


def _write_recurrent(dc, m, params, state) -> JavaObject:
    from .. import nn

    cell = m.layers[0]
    cp = params[0]
    if isinstance(cell, nn.RnnCell):
        act_name = _NAME_BY_ACT.get(id(cell.activation))
        if act_name is None:
            raise ValueError("bigdl format save: RnnCell activation "
                             f"{cell.activation} has no reference class")
        H = cell.hidden_size
        # the fused bias goes to i2h; h2h gets zeros (forward-identical)
        pre = _time_distributed(dc, _linear(
            dc, np.asarray(cp["w_ih"]).T, np.asarray(cp["bias"])))
        h2h = _linear(dc, np.asarray(cp["w_hh"]).T, np.zeros(H, np.float32))
        i2h = _simple(dc, "Identity")
        pt = _parallel_table(dc, i2h, h2h)
        cadd = _cadd(dc, False)
        act = _simple(dc, act_name)
        inner = _seq(dc, pt, cadd, act,
                     _concat_table(dc, _simple(dc, "Identity"),
                                   _simple(dc, "Identity")))
        topo = _obj(dc, "RnnCell", [],
                    [("parallelTable", _MODULE_SIG, pt),
                     ("i2h", _MODULE_SIG, i2h),
                     ("h2h", _MODULE_SIG, h2h),
                     ("cAddTable", _MODULE_SIG, cadd),
                     ("cell", _MODULE_SIG, inner)])
        topo.fields["hiddensShape"] = _hiddens_shape(dc, [H])  # Cell desc
    elif isinstance(cell, nn.LSTM):
        I, H = cell.input_size, cell.hidden_size
        perm = _gate_perm_ref_to_ours(H)     # involution: ours -> ref too
        kernel = np.asarray(cp["kernel"])
        wi = kernel[:I].T[perm]              # (4H, I) rows [i, g, f, o]
        wh = kernel[I:].T[perm]              # (4H, H)
        bi = np.asarray(cp["bias"])[perm]
        pre = _time_distributed(dc, _linear(dc, wi, bi))
        h2g = _linear(dc, wh, None)
        gates = _seq(
            dc, _narrow_table(dc, 1, 2),
            _parallel_table(dc, _simple(dc, "Identity"), h2g),
            _cadd(dc, False), _reshape(dc, [4, H]), _split_table(dc, 1, 2),
            _parallel_table(dc, _simple(dc, "Sigmoid"), _simple(dc, "Tanh"),
                            _simple(dc, "Sigmoid"), _simple(dc, "Sigmoid")))
        cell_layer = _seq(
            dc,
            _concat_table(
                dc,
                _seq(dc, _narrow_table(dc, 1, 2), _simple(dc, "CMulTable")),
                _seq(dc, _concat_table(dc, _select(dc, 3), _select(dc, 5)),
                     _simple(dc, "CMulTable"))),
            _cadd(dc, True))
        lstm = _seq(
            dc, _simple(dc, "FlattenTable"),
            _concat_table(dc, gates, _select(dc, 3)),
            _simple(dc, "FlattenTable"),
            _concat_table(dc, cell_layer, _select(dc, 4)),
            _simple(dc, "FlattenTable"),
            _concat_table(
                dc,
                _seq(dc,
                     _concat_table(dc,
                                   _seq(dc, _select(dc, 1),
                                        _simple(dc, "Tanh")),
                                   _select(dc, 2)),
                     _simple(dc, "CMulTable")),
                _select(dc, 1)),
            _concat_table(dc, _select(dc, 1), _simple(dc, "Identity")))
        topo = _obj(dc, "LSTM",
                    [("I", "inputSize", I), ("I", "hiddenSize", H),
                     ("D", "p", 0.0)],
                    [("gates", _MODULE_SIG, gates),
                     ("cellLayer", _MODULE_SIG, None),
                     ("cell", _MODULE_SIG, lstm)])
        topo.fields["hiddensShape"] = _hiddens_shape(dc, [H, H])  # Cell desc
    elif isinstance(cell, nn.LSTMPeephole):
        I, H = cell.input_size, cell.hidden_size
        kernel = np.asarray(cp["kernel"])
        wi = kernel[:I].T                      # (4H, I), chunks [i,f,g,o]
        bi = np.asarray(cp["bias"])
        pre = _seq(dc, _dropout(dc, 0.0),
                   _time_distributed(dc, _linear(dc, wi, bi)))

        def h2h_seq(chunk):
            w = kernel[I:, chunk * H:(chunk + 1) * H].T    # (H, H)
            return _seq(dc, _dropout(dc, 0.0),
                        _linear(dc, w, None))

        def cmul(weight):
            from .bigdl import _w_tensor
            return _obj(dc, "CMul", [],
                        [("size", "[I", _hiddens_shape(dc, [H])),
                         ("weight", _T, _w_tensor(
                             dc, np.asarray(weight).reshape(H)))])

        def gate(chunk, peep):                 # buildGate, :77-93
            return _seq(
                dc,
                _parallel_table(
                    dc,
                    _obj(dc, "Narrow",
                         [("I", "dimension", 2),
                          ("I", "offset", 1 + chunk * H),
                          ("I", "length", H)], []),
                    h2h_seq(chunk), cmul(peep)),
                _cadd(dc, False), _simple(dc, "Sigmoid"))

        input_gate = gate(0, cp["peep_i"])
        forget_gate = gate(1, cp["peep_f"])
        output_gate = gate(3, cp["peep_o"])
        hidden_layer = _seq(                   # buildHidden, :110-130
            dc, _narrow_table(dc, 1, 2),
            _parallel_table(
                dc,
                _obj(dc, "Narrow",
                     [("I", "dimension", 2), ("I", "offset", 1 + 2 * H),
                      ("I", "length", H)], []),
                h2h_seq(2)),
            _cadd(dc, False), _simple(dc, "Tanh"))
        forget_layer = _seq(
            dc, _concat_table(dc, forget_gate, _select(dc, 3)),
            _simple(dc, "CMulTable"))
        input_layer = _seq(
            dc, _concat_table(dc, input_gate, hidden_layer),
            _simple(dc, "CMulTable"))
        cell_layer = _seq(                     # buildCell, :133-156
            dc, _concat_table(dc, forget_layer, input_layer),
            _cadd(dc, False))
        lstm = _seq(                           # buildLSTM, :159-184
            dc, _simple(dc, "FlattenTable"),
            _concat_table(dc, _narrow_table(dc, 1, 2), cell_layer),
            _simple(dc, "FlattenTable"),
            _concat_table(
                dc,
                _seq(dc,
                     _concat_table(dc, output_gate,
                                   _seq(dc, _select(dc, 3),
                                        _simple(dc, "Tanh"))),
                     _simple(dc, "CMulTable")),
                _select(dc, 3)),
            _concat_table(dc, _select(dc, 1), _simple(dc, "Identity")))
        topo = _obj(dc, "LSTMPeephole",
                    [("I", "inputSize", I), ("I", "hiddenSize", H),
                     ("D", "p", 0.0), ("I", "featDim", 2)],
                    [("inputGate", _MODULE_SIG, input_gate),
                     ("forgetGate", _MODULE_SIG, forget_gate),
                     ("outputGate", _MODULE_SIG, output_gate),
                     ("hiddenLayer", _MODULE_SIG, hidden_layer),
                     ("cellLayer", _MODULE_SIG, cell_layer),
                     ("cell", _MODULE_SIG, lstm)])
        topo.fields["hiddensShape"] = _hiddens_shape(dc, [H, H])
    elif isinstance(cell, nn.GRU):
        I, O = cell.input_size, cell.hidden_size
        gk = np.asarray(cp["gate_kernel"])
        gb = np.asarray(cp["gate_bias"])
        ck = np.asarray(cp["cand_kernel"])
        cb = np.asarray(cp["cand_bias"])
        # ours u = 1 - ref z: negate the u chunk back into z
        wi = np.concatenate([gk[:I, :O].T, -gk[:I, O:].T, ck[:I].T], axis=0)
        bi = np.concatenate([gb[:O], -gb[O:], cb])
        wh2g = np.concatenate([gk[I:, :O].T, -gk[I:, O:].T], axis=0)
        whh = ck[I:].T
        pre = _time_distributed(dc, _linear(dc, wi, bi))
        i2g = _obj(dc, "Narrow",
                   [("I", "dimension", 2), ("I", "offset", 1),
                    ("I", "length", 2 * O)], [])
        h2g = _linear(dc, wh2g, None)
        gates = _seq(
            dc, _parallel_table(dc, i2g, h2g), _cadd(dc, True),
            _reshape(dc, [2, O]), _split_table(dc, 1, 2),
            _parallel_table(dc, _simple(dc, "Sigmoid"),
                            _simple(dc, "Sigmoid")))
        f2g = _obj(dc, "Narrow",
                   [("I", "dimension", 2), ("I", "offset", 1 + 2 * O),
                    ("I", "length", O)], [])
        h_hat = _seq(
            dc,
            _concat_table(dc, _seq(dc, _select(dc, 1), f2g),
                          _seq(dc, _narrow_table(dc, 2, 2),
                               _simple(dc, "CMulTable"))),
            _parallel_table(
                dc, _simple(dc, "Identity"),
                _seq(dc, _dropout(dc, 0.0),
                     _linear(dc, whh, None))),
            _cadd(dc, True), _simple(dc, "Tanh"))
        gru = _seq(
            dc, _concat_table(dc, _simple(dc, "Identity"), gates),
            _simple(dc, "FlattenTable"),
            _concat_table(
                dc,
                _seq(dc,
                     _concat_table(
                         dc, h_hat,
                         _seq(dc,
                              _select(dc, 4),
                              _mul_constant(dc, -1.0),
                              _add_constant(dc, 1.0))),
                     _simple(dc, "CMulTable")),
                _seq(dc, _concat_table(dc, _select(dc, 2), _select(dc, 4)),
                     _simple(dc, "CMulTable"))),
            _cadd(dc, False),
            _concat_table(dc, _simple(dc, "Identity"),
                          _simple(dc, "Identity")))
        topo = _obj(dc, "GRU",
                    [("I", "inputSize", I), ("I", "outputSize", O),
                     ("D", "p", 0.0), ("I", "featDim", 2)],
                    [("i2g", _MODULE_SIG, i2g),
                     ("h2g", _MODULE_SIG, h2g),
                     ("gates", _MODULE_SIG, gates),
                     ("cell", _MODULE_SIG, gru)])
        topo.fields["hiddensShape"] = _hiddens_shape(dc, [O])  # Cell desc
    else:
        raise ValueError(f"bigdl format save: Recurrent cell "
                         f"{type(cell).__name__} not mapped")
    from .bigdl import _scales
    topo.fields.update(_scales(cell))  # the cell module's own grad scale
    rec = _container(dc, "Recurrent", [pre, topo], (),
                     [("topology", _MODULE_SIG, topo),
                      ("preTopology", _MODULE_SIG, pre)])
    rec.fields.update(_scales(m))
    return rec


def _write_graph(dc, m, params, state, w_module) -> JavaObject:
    node_cd = dc.get(_NODE, [("L", "element", "Ljava/lang/Object;"),
                             ("L", "nexts", _BUF_SIG),
                             ("L", "prevs", _BUF_SIG)])
    elems = {}   # id(our Node) -> element JavaObject
    jnodes = {}  # id(our Node) -> Node JavaObject
    for node, p, s in zip(m.exec_order, params, state):
        elems[id(node)] = w_module(dc, node.element, p, s)
        jnodes[id(node)] = JavaObject(node_cd, {})
    known = set(jnodes)
    for node in m.exec_order:
        jn = jnodes[id(node)]
        jn.fields["element"] = elems[id(node)]
        jn.fields["nexts"] = _buffer(
            dc, [jnodes[id(n)] for n in node.next_nodes if id(n) in known])
        jn.fields["prevs"] = _buffer(
            dc, [jnodes[id(n)] for n in node.prev_nodes if id(n) in known])
    return _container(
        dc, "Graph", [elems[id(n)] for n in m.exec_order], (),
        [("inputs", _BUF_SIG,
          _buffer(dc, [jnodes[id(n)] for n in m.input_nodes])),
         ("outputs", _BUF_SIG,
          _buffer(dc, [jnodes[id(n)] for n in m.output_nodes]))])


# ---------------------------------------------------------------------------
# BinaryTreeLSTM (treeLSTMSentiment zoo family)
# ---------------------------------------------------------------------------
# The reference builds its leaf/composer as Graph modules
# (BinaryTreeLSTM.scala:59-111, withGraph=true default): leaf
# c = Linear(I,H)(x), h = Sigmoid(Linear(I,H)(x)) * Tanh(c); composer
# gates i/lf/rf/update/o each = CAddTable(Linear(H,H)(lh), Linear(H,H)(rh))
# -> Sigmoid (Tanh for update), c = i*update + lf*lc + rf*rc,
# h = Sigmoid(o) * Tanh(c).  This framework fuses the ten gate Linears
# into one (2H, 5H) kernel (nn/tree.py, column order [i, f_l, f_r, o, g]),
# so load/save re-homes by identifying each gate's ROLE from the node
# graph: side (lh/rh) from which Input feeds its Linear, role from the
# activation type and what consumes it (update=Tanh; lf/rf multiply the
# lc/rc Inputs; i multiplies the update; o is the h gate).

def _jnodes(graph_obj):
    """All Node objects of a serialized Graph, reachable from inputs."""
    inputs = _seq_items(graph_obj.fields["inputs"])
    seen, out, stack = set(), [], list(inputs)
    while stack:
        jn = stack.pop()
        if id(jn) in seen:
            continue
        seen.add(id(jn))
        out.append(jn)
        stack.extend(_seq_items(jn.fields.get("nexts", [])))
    return inputs, _seq_items(graph_obj.fields["outputs"]), out


def _elem_short(jn):
    e = jn.fields.get("element")
    return _short(e.classname) if isinstance(e, JavaObject) else None


def _build_treelstm(obj: JavaObject, build):
    from .. import nn

    f = obj.fields
    I, H = int(f["inputSize"]), int(f["hiddenSize"])
    gate_output = bool(f.get("gateOutput", True))
    if not gate_output:
        raise ValueError("bigdl format: BinaryTreeLSTM(gateOutput=false) "
                         "not mapped")
    if not bool(f.get("withGraph", True)):
        # withGraph=false builds Sequential/ConcatTable cell trees
        # (createLeafModuleWithSequential, BinaryTreeLSTM.scala:112-139)
        raise ValueError("bigdl format: BinaryTreeLSTM(withGraph=false) "
                         "not mapped (Graph-built cells only)")

    # leaf: Linear feeding a Sigmoid is the o gate; the other is c
    lin_c = lin_o = None
    _, _, nodes = _jnodes(f["leafModule"])
    for jn in nodes:
        if _elem_short(jn) != "Linear":
            continue
        nxts = [_elem_short(n) for n in _seq_items(jn.fields["nexts"])]
        if "Sigmoid" in nxts:
            lin_o = jn.fields["element"]
        else:
            lin_c = jn.fields["element"]
    if lin_c is None or lin_o is None:
        raise ValueError("bigdl format: BinaryTreeLSTM leaf graph not "
                         "recognized")
    wc, bc = _ref_linear_wb(lin_c)
    wo, bo = _ref_linear_wb(lin_o)

    # composer: role-identify the five CAddTable gates
    inputs, _, nodes = _jnodes(f["composer"])
    if len(inputs) != 4:
        raise ValueError("bigdl format: BinaryTreeLSTM composer graph "
                         f"has {len(inputs)} inputs, expected 4 "
                         "(lc, lh, rc, rh)")
    lc_n, lh_n, rc_n, rh_n = inputs
    gates = {}
    update_act = None
    cadds = [jn for jn in nodes
             if _elem_short(jn) == "CAddTable"
             and len([p for p in _seq_items(jn.fields["prevs"])
                      if _elem_short(p) == "Linear"]) == 2]
    for jn in cadds:
        w_side = {}
        for p in _seq_items(jn.fields["prevs"]):
            if _elem_short(p) != "Linear":
                continue
            feeder = _seq_items(p.fields["prevs"])[0]
            if feeder is lh_n:
                w_side["l"] = p.fields["element"]
            elif feeder is rh_n:
                w_side["r"] = p.fields["element"]
        acts = [n for n in _seq_items(jn.fields["nexts"])
                if _elem_short(n) in ("Sigmoid", "Tanh")]
        if len(w_side) != 2 or len(acts) != 1:
            raise ValueError("bigdl format: BinaryTreeLSTM composer gate "
                             "not recognized")
        act = acts[0]
        if _elem_short(act) == "Tanh":
            role = "g"
            update_act = act
        else:
            role = None
            for consumer in _seq_items(act.fields["nexts"]):
                if _elem_short(consumer) != "CMulTable":
                    continue
                partners = [p for p in _seq_items(consumer.fields["prevs"])
                            if p is not act]
                for partner in partners:
                    if partner is lc_n:
                        role = "f_l"
                    elif partner is rc_n:
                        role = "f_r"
            if role is None:
                role = "_sigmoid_pending"
        gates[id(jn)] = (role, w_side, act)

    # second pass: i multiplies the update Tanh; o is the remaining one
    roles = {}
    for role, w_side, act in gates.values():
        if role == "_sigmoid_pending":
            is_i = any(
                update_act is not None and partner is update_act
                for consumer in _seq_items(act.fields["nexts"])
                if _elem_short(consumer) == "CMulTable"
                for partner in _seq_items(consumer.fields["prevs"])
                if partner is not act)
            role = "i" if is_i else "o"
        roles[role] = w_side
    if sorted(roles) != ["f_l", "f_r", "g", "i", "o"]:
        raise ValueError(f"bigdl format: BinaryTreeLSTM composer roles "
                         f"{sorted(roles)} incomplete")

    cols = {"i": 0, "f_l": 1, "f_r": 2, "o": 3, "g": 4}
    comp_w = np.zeros((2 * H, 5 * H), np.float32)
    comp_b = np.zeros((5 * H,), np.float32)
    for role, w_side in roles.items():
        c0 = cols[role] * H
        wl, bl = _ref_linear_wb(w_side["l"])
        wr, br = _ref_linear_wb(w_side["r"])
        comp_w[:H, c0:c0 + H] = wl.T
        comp_w[H:, c0:c0 + H] = wr.T
        comp_b[c0:c0 + H] = ((bl if bl is not None else 0.0)
                             + (br if br is not None else 0.0))

    m = nn.BinaryTreeLSTM(I, H, gate_output)
    p = {"leaf_c": wc.T.copy(), "leaf_cb": np.asarray(bc, np.float32),
         "leaf_o": wo.T.copy(), "leaf_ob": np.asarray(bo, np.float32),
         "comp_w": comp_w, "comp_b": comp_b}
    return m, p, {}


def _write_treelstm(dc, m, params, w_module):
    """Emit the reference-shaped leaf/composer Graphs with re-homed
    weights, then the BinaryTreeLSTM object around them."""
    from .. import nn
    from .bigdl import _w_buffer, _w_tensor

    if not m.gate_output:
        # the load path refuses gateOutput=false streams; emitting one
        # here would silently write o-gated graphs a real JVM computes
        # differently with
        raise ValueError("bigdl format save: "
                         "BinaryTreeLSTM(gate_output=False) not mapped")
    I, H = m.input_size, m.hidden_size
    cols = {"i": 0, "f_l": 1, "f_r": 2, "o": 3, "g": 4}
    comp_w = np.asarray(params["comp_w"])
    comp_b = np.asarray(params["comp_b"])

    lin_params = {}

    def linear(w_out_in, b):
        lin = nn.Linear(w_out_in.shape[1], w_out_in.shape[0])
        lin_params[id(lin)] = {"weight": np.asarray(w_out_in, np.float32),
                               "bias": np.asarray(b, np.float32)}
        return lin

    # leaf graph (BinaryTreeLSTM.scala:59-76)
    inp = nn.Input()
    c = linear(np.asarray(params["leaf_c"]).T, params["leaf_cb"])(inp)
    o = nn.Sigmoid()(
        linear(np.asarray(params["leaf_o"]).T, params["leaf_ob"])(inp))
    h = nn.CMulTable()([o, nn.Tanh()(c)])
    leaf_graph = nn.Graph(inp, [c, h])

    # composer graph (:78-111)
    lc, lh, rc, rh = (nn.Input() for _ in range(4))

    def gate(role):
        c0 = cols[role] * H
        wl = comp_w[:H, c0:c0 + H].T      # (H, H) out,in
        wr = comp_w[H:, c0:c0 + H].T
        # the fused bias goes to the lh-side Linear; rh-side gets zeros
        add = nn.CAddTable()([linear(wl, comp_b[c0:c0 + H])(lh),
                              linear(wr, np.zeros(H, np.float32))(rh)])
        act = nn.Tanh() if role == "g" else nn.Sigmoid()
        return act(add)

    gi, gfl, gfr, gu = gate("i"), gate("f_l"), gate("f_r"), gate("g")
    go = gate("o")
    c2 = nn.CAddTable()([nn.CMulTable()([gi, gu]),
                         nn.CMulTable()([gfl, lc]),
                         nn.CMulTable()([gfr, rc])])
    h2 = nn.CMulTable()([go, nn.Tanh()(c2)])
    comp_graph = nn.Graph([lc, lh, rc, rh], [c2, h2])

    def graph_obj(g):
        ps = [lin_params.get(id(mod), {}) for mod in g.layers]
        ss = [{} for _ in g.layers]
        return _write_graph(dc, g, ps, ss, w_module)

    leaf_obj = graph_obj(leaf_graph)
    comp_obj = graph_obj(comp_graph)
    tree = _obj(dc, "BinaryTreeLSTM",
                [("Z", "gateOutput", True), ("Z", "withGraph", True)],
                [("composer", _MODULE_SIG, comp_obj),
                 ("leafModule", _MODULE_SIG, leaf_obj),
                 ("composers", _BUF_SIG, _w_buffer(dc, [comp_obj])),
                 ("leafModules", _BUF_SIG, _w_buffer(dc, [leaf_obj])),
                 ("cells", _BUF_SIG, _w_buffer(dc, []))])
    # TreeLSTM super-desc fields (inputSize/hiddenSize/memZero)
    tree.fields["inputSize"] = I
    tree.fields["hiddenSize"] = H
    tree.fields["memZero"] = _w_tensor(dc, np.zeros(H, np.float32))
    return tree
