"""Caffe model interop: load .caffemodel files into the port's modules and
persist modules back out.

Counterpart of ``bigdl_tpu/interop/caffe.py``: the same codec and layer
mapping; the loader builds its ``Graph`` on the device the caller names
(the CUDA device by default; it raises without one) and installs the
blobs through ``Module.attach``, and the persister reads a module's own
leaves where it is given no trees.

Reference: utils/caffe/CaffeLoader.scala:56 (loadBinary :93, copyParameters
:239, layer mapping in Converter/LayerConverter/V1LayerConverter.scala) and
utils/caffe/CaffePersister.scala, all driven by the protoc-generated
caffe/Caffe.java.  Rebuild: the generic wire codec (utils/pbwire.py) plus
the public caffe.proto field numbers below; layers map to nn modules and
weights are transposed into our NHWC/HWIO layouts.

Layout notes (the cross-framework traps):
  * conv blobs are OIHW -> our HWIO; activations NCHW -> our NHWC.
  * InnerProduct weights flatten the preceding conv feature map in
    (C, H, W) order; our flatten is NHWC, i.e. (H, W, C) order — the
    loader permutes FC weight columns at any spatial->InnerProduct
    boundary (and the persister permutes back), so genuine pretrained
    caffemodels predict correctly (reference: LayerConverter's fcbackend
    handling; round-1 advisor finding).
  * BatchNorm stores (mean, var, scale_factor) with a separate Scale
    layer for gamma/beta — the loader folds an adjacent Scale into one
    affine SpatialBatchNormalization, like LayerConverter.scala's
    BatchNorm+Scale fusion.

caffe.proto field numbers used (public schema):
    NetParameter: name=1, input=3, layers(V1)=2, layer(V2)=100
    LayerParameter: name=1, type=2 (string), bottom=3, top=4, blobs=7,
        concat_param=104, pooling_param=103, convolution_param=106,
        dropout_param=108, eltwise_param=110, inner_product_param=117,
        lrn_param=118, power_param=122, reshape_param=133,
        batch_norm_param=139, scale_param=142
    V1LayerParameter: bottom=2, top=3, name=4, type=5 (enum), blobs=6,
        concat_param=9, convolution_param=10, dropout_param=12,
        inner_product_param=17, lrn_param=18, pooling_param=19,
        power_param=21, eltwise_param=24
    BlobProto: shape=7 (BlobShape.dim=1), data=5 (packed float),
        num=1 channels=2 height=3 width=4 (legacy 4-D)
    ConvolutionParameter: num_output=1 bias_term=2 pad=3 kernel_size=4
        group=5 stride=6 pad_h=9 pad_w=10 kernel_h=11 kernel_w=12
        stride_h=13 stride_w=14 dilation=18
    PoolingParameter: pool=1 (0 MAX, 1 AVE) kernel_size=2 stride=3 pad=4
        kernel_h=5 kernel_w=6 stride_h=7 stride_w=8 pad_h=9 pad_w=10
        global_pooling=12 round_mode=13 (0 CEIL, 1 FLOOR)
    InnerProductParameter: num_output=1 bias_term=2
    LRNParameter: local_size=1 alpha=2 beta=3 norm_region=4 k=5
    DropoutParameter: dropout_ratio=1
    ConcatParameter: concat_dim=1 (legacy) axis=2
    EltwiseParameter: operation=1 (0 PROD, 1 SUM, 2 MAX) coeff=2
    PowerParameter: power=1 scale=2 shift=3
    ReshapeParameter: shape=1 (BlobShape)
    BatchNormParameter: use_global_stats=1 moving_average_fraction=2 eps=3
    ScaleParameter: axis=1 num_axes=2 bias_term=4
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import pbwire
from ..utils.pbwire import Fields

logger = logging.getLogger(__name__)

__all__ = ["CaffeLoader", "CaffePersister", "load_caffe", "save_caffe"]

# V1LayerParameter.LayerType enum -> V2 string type (public caffe.proto)
_V1_TYPES = {
    2: "BNLL", 3: "Concat", 4: "Convolution", 5: "Data", 6: "Dropout",
    8: "Flatten", 14: "InnerProduct", 15: "LRN", 17: "Pooling", 18: "ReLU",
    19: "Sigmoid", 20: "Softmax", 21: "SoftmaxWithLoss", 22: "Split",
    23: "TanH", 25: "Eltwise", 26: "Power", 33: "Slice", 35: "AbsVal",
    36: "Silence", 38: "Exp", 39: "Deconvolution",
}

# caffe NCHW axis -> our NHWC axis
_NCHW_TO_NHWC = {0: 0, 1: -1, 2: 1, 3: 2}
_NHWC_TO_NCHW = {0: 0, -1: 1, 3: 1, 1: 2, 2: 3}


class _Layer:
    """Parsed layer description, schema-neutral between V1 and V2."""

    def __init__(self, name: str, type_: str, bottoms: List[str],
                 tops: List[str], blobs: List[np.ndarray],
                 blob_shapes: List[Tuple[int, ...]], params: Dict[int, Fields]):
        self.name = name
        self.type = type_
        self.bottoms = bottoms
        self.tops = tops
        self.blobs = blobs
        self.blob_shapes = blob_shapes
        self.params = params


def _parse_blob(f: Fields) -> Tuple[np.ndarray, Tuple[int, ...]]:
    data = np.array(f.floats(5), dtype=np.float32)
    if f.has(7):
        shape = tuple(f.sub(7).ints(1))
    else:  # legacy num/channels/height/width
        shape = tuple(f.int(i, 1) for i in (1, 2, 3, 4))
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
    if data.size and int(np.prod(shape)) == data.size:
        data = data.reshape(shape)
    return data, shape


# LayerParameter param-message fields the loader reads, keyed by the V2
# field number (V1 layers are remapped onto the same keys).
_V2_PARAM_FIELDS = (103, 104, 106, 108, 110, 117, 118, 122, 133, 139, 142)
_V1_PARAM_MAP = {103: 19, 104: 9, 106: 10, 108: 12, 110: 24, 117: 17,
                 118: 18, 122: 21}


def _parse_layers(buf: bytes) -> Tuple[str, List[_Layer]]:
    net = Fields(buf)
    layers: List[_Layer] = []
    for lf in net.subs(100):  # V2
        blobs = [_parse_blob(b) for b in lf.subs(7)]
        layers.append(_Layer(
            lf.str(1), lf.str(2), lf.strs(3), lf.strs(4),
            [b for b, _ in blobs], [s for _, s in blobs],
            {n: lf.sub(n) for n in _V2_PARAM_FIELDS if lf.has(n)}))
    for lf in net.subs(2):  # V1
        blobs = [_parse_blob(b) for b in lf.subs(6)]
        layers.append(_Layer(
            lf.str(4), _V1_TYPES.get(lf.int(5), f"V1_{lf.int(5)}"),
            lf.strs(2), lf.strs(3),
            [b for b, _ in blobs], [s for _, s in blobs],
            {v2: lf.sub(v1) for v2, v1 in _V1_PARAM_MAP.items()}))
    return net.str(1), layers


def _conv_args(p: Fields):
    kh = p.int(11) or (p.ints(4)[0] if p.ints(4) else 1)
    kw = p.int(12) or (p.ints(4)[-1] if p.ints(4) else 1)
    sh = p.int(13) or (p.ints(6)[0] if p.ints(6) else 1)
    sw = p.int(14) or (p.ints(6)[-1] if p.ints(6) else 1)
    ph = p.int(9) or (p.ints(3)[0] if p.ints(3) else 0)
    pw = p.int(10) or (p.ints(3)[-1] if p.ints(3) else 0)
    return kh, kw, sh, sw, ph, pw, p.int(1), p.int(5, 1), p.int(2, 1)


def _fc_cols_chw_to_hwc(w: np.ndarray, channels: int) -> np.ndarray:
    """Permute FC weight columns from caffe's (C,H,W) flatten order to our
    NHWC (H,W,C) order.  Only C and H*W matter: column c*HW + hw moves to
    hw*C + c."""
    out, n_in = w.shape
    hw = n_in // channels
    return (w.reshape(out, channels, hw).transpose(0, 2, 1)
            .reshape(out, n_in))


def _fc_cols_hwc_to_chw(w: np.ndarray, channels: int) -> np.ndarray:
    out, n_in = w.shape
    hw = n_in // channels
    return (w.reshape(out, hw, channels).transpose(0, 2, 1)
            .reshape(out, n_in))


def _host_copy(t):
    """A tensor as a numpy array of its own (not a view of a CPU
    parameter)."""
    return t.detach().cpu().numpy().copy()


def _own_trees(model, params, state):
    """(params, state), the module's own (``to_reference_tree``) in place
    of either that is None."""
    if params is None or state is None:
        from ..utils.convert import to_reference_tree
        own_params, own_state = to_reference_tree(model)
        params = own_params if params is None else params
        state = own_state if state is None else state
    return params, state


class CaffeLoader:
    """Build a port Graph from a binary .caffemodel
    (reference: CaffeLoader.loadBinary + Converter.toBigDL).

    Unsupported layer types raise by default (round-1 advisor: silent
    Identity mapping makes imports "succeed" and predict garbage); pass
    ``permissive=True`` to map them to Identity with a warning."""

    def __init__(self, path: str, permissive: bool = False):
        with open(path, "rb") as f:
            self.net_name, self.layers = _parse_layers(f.read())
        self.permissive = permissive

    def build(self, device=None):
        """Returns (module, params_tree): a Graph wired by bottom/top names,
        built on ``device`` (default the CUDA device), with weights copied
        in (conv blobs OIHW -> HWIO, NCHW -> NHWC); the tree's leaves are
        numpy."""
        import torch

        from .. import nn
        from ..common import resolve_device
        from ..utils.convert import to_reference_tree
        from ..nn.graph import Graph, Input

        tensors: Dict[str, object] = {}
        inputs = []
        params: Dict[str, Dict] = {}
        modules: Dict[str, object] = {}
        channels: Dict[str, Optional[int]] = {}  # tensor -> NHWC channels
        spatial: Dict[str, bool] = {}            # tensor -> is 4-D NHWC
        flat_ch: Dict[str, Optional[int]] = {}   # flattened-from channels
        consumed = set()  # layer indices folded into a predecessor

        def get_bottom(name):
            if name not in tensors:
                node = Input()
                tensors[name] = node
                inputs.append(node)
            return tensors[name]

        for i, ly in enumerate(self.layers):
            if i in consumed:
                continue
            t = ly.type
            mod = None
            p: Optional[Dict] = None
            bottom0 = ly.bottoms[0] if ly.bottoms else None
            in_ch = channels.get(bottom0)
            out_ch = in_ch
            out_spatial = spatial.get(bottom0, False)
            if t in ("Data", "Input", "Split", "Silence"):
                # data layers introduce tensors; assume image data is spatial
                for top in ly.tops:
                    spatial[top] = True
                continue
            elif t == "Convolution":
                kh, kw, sh, sw, ph, pw, n_out, group, bias = _conv_args(
                    ly.params.get(106, Fields(b"")))
                w = ly.blobs[0]  # (out, in/g, kh, kw)
                n_in = w.shape[1] * group
                mod = nn.SpatialConvolution(n_in, n_out, kw, kh, sw, sh,
                                            pw, ph, group,
                                            with_bias=bool(bias))
                p = {"weight": np.transpose(w, (2, 3, 1, 0))}
                if bias and len(ly.blobs) > 1:
                    p["bias"] = ly.blobs[1].reshape(-1)
                out_ch, out_spatial = n_out, True
            elif t == "Deconvolution":
                kh, kw, sh, sw, ph, pw, n_out, group, bias = _conv_args(
                    ly.params.get(106, Fields(b"")))
                if group != 1:
                    raise ValueError("caffe Deconvolution with group > 1 "
                                     "is not supported")
                w = ly.blobs[0]  # (in, out, kh, kw)
                mod = nn.SpatialFullConvolution(
                    w.shape[0], n_out, kw, kh, sw, sh, pw, ph,
                    no_bias=not bias)
                p = {"weight": np.transpose(w, (2, 3, 0, 1))}
                if bias and len(ly.blobs) > 1:
                    p["bias"] = ly.blobs[1].reshape(-1)
                out_ch, out_spatial = n_out, True
            elif t == "BatchNorm":
                bp = ly.params.get(139, Fields(b""))
                eps = bp.float(3, 1e-5)
                n_c = int(ly.blob_shapes[0][0])
                sf = float(ly.blobs[2].reshape(-1)[0]) if len(ly.blobs) > 2 \
                    else 1.0
                sf = sf if sf != 0 else 1.0
                mean = ly.blobs[0].reshape(-1) / sf
                var = ly.blobs[1].reshape(-1) / sf
                # fold an adjacent Scale (gamma/beta) into affine BN, like
                # LayerConverter.scala's BatchNorm+Scale pairing
                nxt = (self.layers[i + 1]
                       if i + 1 < len(self.layers) else None)
                fold = (nxt is not None and nxt.type == "Scale"
                        and nxt.bottoms and nxt.bottoms[0] == ly.tops[0])
                mod = nn.SpatialBatchNormalization(n_c, eps=eps,
                                                   affine=fold)
                p = {"__state__": {"running_mean": mean,
                                   "running_var": var}}
                if fold:
                    p["weight"] = nxt.blobs[0].reshape(-1)
                    p["bias"] = (nxt.blobs[1].reshape(-1)
                                 if len(nxt.blobs) > 1
                                 else np.zeros(n_c, np.float32))
                    consumed.add(i + 1)
                    ly = _Layer(ly.name, ly.type, ly.bottoms, nxt.tops,
                                ly.blobs, ly.blob_shapes, ly.params)
                out_ch = n_c
            elif t == "Scale":
                sp = ly.params.get(142, Fields(b""))
                w = ly.blobs[0].reshape(-1)
                mod = nn.Scale((w.shape[0],))
                bias = (ly.blobs[1].reshape(-1)
                        if sp.int(4, 0) and len(ly.blobs) > 1
                        else np.zeros_like(w))
                p = {"weight": w, "bias": bias}
                out_ch = w.shape[0]
            elif t == "InnerProduct":
                ip = ly.params.get(117, Fields(b""))
                w = ly.blobs[0]
                w = w.reshape(ip.int(1), -1)
                c = in_ch if out_spatial else flat_ch.get(bottom0)
                if c and w.shape[1] % c == 0:
                    w = _fc_cols_chw_to_hwc(w, c)
                linear = nn.Linear(w.shape[1], w.shape[0],
                                   with_bias=bool(ip.int(2, 1)))
                if out_spatial:
                    # caffe InnerProduct flattens its 4-D bottom implicitly
                    mod = (nn.Sequential()
                           .add(nn.InferReshape((0, -1))).add(linear))
                    p = {"__child__": 1, "weight": w}
                else:
                    mod = linear
                    p = {"weight": w}
                if ip.int(2, 1) and len(ly.blobs) > 1:
                    p["bias"] = ly.blobs[1].reshape(-1)
                out_ch, out_spatial = w.shape[0], False
            elif t == "Pooling":
                pp = ly.params.get(103, Fields(b""))
                kh = pp.int(5) or pp.int(2, 1)
                kw = pp.int(6) or pp.int(2, 1)
                sh = pp.int(7) or pp.int(3, 1)
                sw = pp.int(8) or pp.int(3, 1)
                ph = pp.int(9) or pp.int(4, 0)
                pw = pp.int(10) or pp.int(4, 0)
                ceil = pp.int(13, 0) == 0  # round_mode: 0 CEIL (default)
                is_max = pp.int(1, 0) == 0
                if pp.int(12, 0):  # global_pooling
                    if is_max:
                        raise ValueError("global MAX pooling unsupported")
                    mod = nn.SpatialAveragePooling(1, 1,
                                                   global_pooling=True)
                elif is_max:
                    mod = nn.SpatialMaxPooling(kw, kh, sw, sh, pw, ph)
                    if ceil:
                        mod.ceil()
                else:
                    mod = nn.SpatialAveragePooling(kw, kh, sw, sh, pw, ph,
                                                   ceil_mode=ceil)
            elif t == "ReLU":
                mod = nn.ReLU()
            elif t == "TanH":
                mod = nn.Tanh()
            elif t == "Sigmoid":
                mod = nn.Sigmoid()
            elif t == "AbsVal":
                mod = nn.Abs()
            elif t == "BNLL":
                mod = nn.SoftPlus()
            elif t == "Exp":
                mod = nn.Exp()
            elif t == "Log":
                mod = nn.Log()
            elif t == "Power":
                pw_ = ly.params.get(122, Fields(b""))
                mod = nn.Power(pw_.float(1, 1.0), pw_.float(2, 1.0),
                               pw_.float(3, 0.0))
            elif t in ("Softmax", "SoftmaxWithLoss"):
                mod = nn.SoftMax()
            elif t == "Dropout":
                ratio = ly.params.get(108, Fields(b"")).float(1, 0.5)
                mod = nn.Dropout(ratio)
            elif t == "LRN":
                lp = ly.params.get(118, Fields(b""))
                mod = nn.SpatialCrossMapLRN(lp.int(1, 5), lp.float(2, 1.0),
                                            lp.float(3, 0.75),
                                            lp.float(5, 1.0))
            elif t == "Flatten":
                mod = nn.InferReshape((0, -1))
                for top in ly.tops:
                    flat_ch[top] = in_ch
                out_spatial = False
            elif t == "Reshape":
                dims = tuple(ly.params.get(133, Fields(b""))
                             .sub(1).ints(1)) or (0, -1)
                if len(dims) == 4:  # caffe (0,C,H,W) -> our NHWC
                    dims = (dims[0], dims[2], dims[3], dims[1])
                    out_spatial = True
                    out_ch = dims[3]
                else:
                    if out_spatial:
                        for top in ly.tops:
                            flat_ch[top] = in_ch
                    out_spatial = False
                mod = nn.InferReshape(dims)
            elif t == "Concat":
                cp = ly.params.get(104, Fields(b""))
                axis = cp.int(2, 1) if cp.has(2) else cp.int(1, 1)
                if axis < 0:  # caffe negative axes count from rank (NCHW 4-D)
                    axis += 4
                if axis not in _NCHW_TO_NHWC:
                    raise ValueError(f"Concat axis {axis} unsupported")
                mod = nn.JoinTable(_NCHW_TO_NHWC[axis])
                if axis == 1:
                    chs = [channels.get(b) for b in ly.bottoms]
                    out_ch = (sum(chs) if all(c is not None for c in chs)
                              else None)
            elif t == "Eltwise":
                ep = ly.params.get(110, Fields(b""))
                coeffs = ep.floats(2)
                if coeffs and any(c != 1.0 for c in coeffs):
                    raise ValueError("Eltwise with non-unit coefficients "
                                     "is not supported")
                op = ep.int(1, 1)
                mod = {0: nn.CMulTable, 1: nn.CAddTable,
                       2: nn.CMaxTable}[op]()
            else:
                if not self.permissive:
                    raise ValueError(
                        f"caffe layer type {t!r} ({ly.name}) unsupported; "
                        "pass permissive=True to map it to Identity")
                logger.warning("caffe layer type %s (%s) unsupported; "
                               "treating as identity", t, ly.name)
                mod = nn.Identity()

            bottoms = [get_bottom(b) for b in ly.bottoms]
            if len(bottoms) == 1:
                node = mod(bottoms[0])
            else:
                node = mod(bottoms)
            for top in ly.tops:
                tensors[top] = node
                channels[top] = out_ch
                spatial[top] = out_spatial
            modules[ly.name] = mod
            if p is not None:
                params[ly.name] = p

        last = next(ly for ly in reversed(self.layers)
                    if ly.tops and ly.tops[0] in tensors)
        graph = Graph(inputs if len(inputs) > 1 else inputs[0],
                      tensors[last.tops[0]])
        graph.build(resolve_device(device), torch.Generator().manual_seed(0))
        init_params, init_state = to_reference_tree(graph, fetch=_host_copy)
        self._copy_params(graph, init_params, init_state, modules, params)
        graph.attach(init_params, init_state)
        return graph, init_params

    @staticmethod
    def _copy_params(graph, init_params, init_state, modules, params):
        """Overwrite initialized leaves with loaded blobs
        (reference: CaffeLoader.copyParameters — match by name, fail loud
        on shape mismatch).  "__state__" entries target the module's state
        (BN running stats); "__child__" redirects into a child of a
        wrapper Sequential."""
        name_by_module = {id(m): n for n, m in modules.items()}
        for i, m in enumerate(graph.layers):
            lname = name_by_module.get(id(m))
            if not lname or lname not in params:
                continue
            loaded = dict(params[lname])
            st = loaded.pop("__state__", None)
            child = loaded.pop("__child__", None)
            tgt = init_params[i] if child is None else init_params[i][child]
            for k, v in loaded.items():
                want = np.asarray(tgt[k]).shape
                if v.shape != want:
                    raise ValueError(
                        f"caffe layer {lname} param {k}: shape "
                        f"{v.shape} vs model {want}")
                tgt[k] = v.astype(np.asarray(tgt[k]).dtype)
            if st:
                stgt = init_state[i] if child is None else init_state[i][child]
                for k, v in st.items():
                    want = np.asarray(stgt[k]).shape
                    if v.shape != want:
                        raise ValueError(
                            f"caffe layer {lname} state {k}: shape "
                            f"{v.shape} vs model {want}")
                    stgt[k] = v.astype(np.asarray(stgt[k]).dtype)
        return init_params


def load_caffe(path: str, permissive: bool = False, device=None):
    """(reference: Module.loadCaffe, nn/Module.scala:50): (Graph built on
    ``device``, its params tree)."""
    return CaffeLoader(path, permissive=permissive).build(device)


class _EmitCtx:
    """Accumulates NetParameter layer messages + per-tensor layout facts."""

    def __init__(self):
        self.chunks: List[bytes] = []
        self.n = 0
        self.ch: Optional[int] = None      # channels of the current tensor
        self.spatial = True                # current tensor is 4-D NHWC
        self.flat_ch: Optional[int] = None  # channels before the flatten
        self.topology: List[tuple] = []    # (name, type, bottoms, top)

    def layer(self, type_s: str, bottoms, blobs=(), extra: bytes = b"",
              top: str = None) -> str:
        name = f"{type_s.lower()}_{self.n}"
        self.n += 1
        top = top or name
        self.topology.append((name, type_s, list(bottoms), top))
        body = (pbwire.field_string(1, name) +
                pbwire.field_string(2, type_s))
        for b in bottoms:
            body += pbwire.field_string(3, b)
        body += pbwire.field_string(4, top)
        body += extra
        for b in blobs:
            body += pbwire.field_bytes(7, CaffePersister._blob(b))
        self.chunks.append(pbwire.field_bytes(100, body))
        return top


class CaffePersister:
    """Write a model (Sequential / Graph-free composite of supported layers,
    including ConcatTable+Eltwise residual branches and Concat towers) back
    to a binary NetParameter (reference: utils/caffe/CaffePersister.scala)."""

    @staticmethod
    def _blob(arr: np.ndarray) -> bytes:
        shape_msg = b"".join(pbwire.field_varint(1, int(d))
                             for d in arr.shape)
        return (pbwire.field_bytes(7, shape_msg) +
                pbwire.field_packed_floats(5, arr.ravel()))

    @classmethod
    def save(cls, model, params, path: str, net_name: str = "bigdl_torch",
             state=None, prototxt_path: str = None):
        """Binary NetParameter to `path`; with `prototxt_path`, also a text
        net definition (layer name/type/bottom/top topology, weight-free) —
        the two-file contract of the reference's
        CaffePersister.saveToCaffe(prototxtPath, modelPath).  ``params``
        or ``state`` None: the module's own (``to_reference_tree``)."""
        params, state = _own_trees(model, params, state)
        ctx = _EmitCtx()
        cls._emit(model, params, state, "data", ctx)
        with open(path, "wb") as f:
            f.write(b"".join([pbwire.field_string(1, net_name)] + ctx.chunks))
        if prototxt_path is not None:
            lines = [f'name: "{net_name}"']
            for name, type_s, bottoms, top in ctx.topology:
                lines.append("layer {")
                lines.append(f'  name: "{name}"')
                lines.append(f'  type: "{type_s}"')
                for b in bottoms:
                    lines.append(f'  bottom: "{b}"')
                lines.append(f'  top: "{top}"')
                lines.append("}")
            with open(prototxt_path, "w") as f:
                f.write("\n".join(lines) + "\n")
        return path

    @staticmethod
    def _resolve_same_pad(mod, kind: str):
        kh, kw = mod.kernel
        sh, sw = mod.stride
        ph, pw = mod.pad
        if ph == -1 or pw == -1:
            # SAME sentinel: caffe has only explicit pads; exact only for
            # stride-1 odd kernels (conv and pooling alike)
            if (sh, sw) == (1, 1) and kh % 2 == 1 and kw % 2 == 1:
                ph, pw = kh // 2, kw // 2
            else:
                raise ValueError(
                    f"CaffePersister: SAME padding (pad=-1) on {kind} with "
                    f"stride {mod.stride} kernel {mod.kernel} has no exact "
                    "caffe equivalent")
        return kh, kw, sh, sw, ph, pw

    @classmethod
    def _emit(cls, mod, p, s, bottom, ctx: _EmitCtx):
        """Emit `mod` taking tensor `bottom` (a top name, or a list of top
        names after a ConcatTable); returns the new top."""
        from .. import nn
        from ..nn.containers import (ConcatTable, Concat as ConcatC,
                                     Identity, Sequential)
        from ..nn.graph import Graph, _InputModule

        def sub_s(i):
            return s[i] if s is not None else None

        if isinstance(mod, Graph):
            # walk exec_order, naming tensors per node so load->save
            # round-trips work (the loader returns a Graph)
            if len(mod.input_nodes) != 1:
                raise ValueError("CaffePersister: multi-input Graph "
                                 "persistence is unsupported")
            names = {id(mod.input_nodes[0]): bottom}
            layouts = {id(mod.input_nodes[0]):
                       (ctx.ch, ctx.spatial, ctx.flat_ch)}
            for i, n in enumerate(mod.exec_order):
                if id(n) in names:
                    continue
                preds = n.prev_nodes
                bots = [names[id(pn)] for pn in preds]
                ctx.ch, ctx.spatial, ctx.flat_ch = layouts[id(preds[0])]
                top = cls._emit(n.element, p[i], sub_s(i),
                                bots[0] if len(bots) == 1 else bots, ctx)
                names[id(n)] = top
                layouts[id(n)] = (ctx.ch, ctx.spatial, ctx.flat_ch)
            return names[id(mod.output_nodes[0])]
        if isinstance(mod, _InputModule):
            return bottom
        if isinstance(mod, Sequential):
            top = bottom
            for i, m in enumerate(mod.layers):
                top = cls._emit(m, p[i], sub_s(i), top, ctx)
            return top
        if isinstance(mod, ConcatTable):
            tops, states = [], []
            ch0, sp0, fc0 = ctx.ch, ctx.spatial, ctx.flat_ch
            for i, m in enumerate(mod.layers):
                ctx.ch, ctx.spatial, ctx.flat_ch = ch0, sp0, fc0
                tops.append(cls._emit(m, p[i], sub_s(i), bottom, ctx))
                states.append((ctx.ch, ctx.spatial, ctx.flat_ch))
            ctx.ch, ctx.spatial, ctx.flat_ch = states[0]
            return tops
        if isinstance(mod, ConcatC):
            tops = []
            chs = []
            ch0, sp0, fc0 = ctx.ch, ctx.spatial, ctx.flat_ch
            for i, m in enumerate(mod.layers):
                ctx.ch, ctx.spatial, ctx.flat_ch = ch0, sp0, fc0
                tops.append(cls._emit(m, p[i], sub_s(i), bottom, ctx))
                chs.append(ctx.ch)
            axis = _NHWC_TO_NCHW.get(mod.dimension)
            if axis is None:
                raise ValueError(f"Concat along axis {mod.dimension} has no "
                                 "caffe NCHW equivalent")
            ctx.ch = (sum(chs) if axis == 1 and
                      all(c is not None for c in chs) else None)
            ctx.spatial = sp0
            extra = pbwire.field_bytes(104, pbwire.field_varint(2, axis))
            return ctx.layer("Concat", tops, extra=extra)
        if isinstance(mod, Identity):
            return bottom
        if isinstance(mod, (nn.CAddTable, nn.CMulTable, nn.CMaxTable)):
            if not isinstance(bottom, list):
                raise ValueError("Eltwise layer needs a list input "
                                 "(ConcatTable upstream)")
            op = {nn.CMulTable: 0, nn.CAddTable: 1, nn.CMaxTable: 2}[
                type(mod)]
            extra = pbwire.field_bytes(110, pbwire.field_varint(1, op))
            return ctx.layer("Eltwise", bottom, extra=extra)
        if isinstance(mod, nn.JoinTable):
            if not isinstance(bottom, list):
                raise ValueError("JoinTable needs a list input")
            axis = _NHWC_TO_NCHW.get(mod.dimension)
            if axis is None:
                raise ValueError(f"JoinTable axis {mod.dimension} has no "
                                 "caffe NCHW equivalent")
            extra = pbwire.field_bytes(104, pbwire.field_varint(2, axis))
            return ctx.layer("Concat", bottom, extra=extra)

        if isinstance(bottom, list):
            raise ValueError(
                f"CaffePersister: {type(mod).__name__} cannot take the "
                "multi-tensor output of a ConcatTable")

        if isinstance(mod, nn.SpatialConvolution):
            w = np.transpose(np.asarray(p["weight"], np.float32),
                             (3, 2, 0, 1))
            blobs = [w]
            if "bias" in p:
                blobs.append(np.asarray(p["bias"], np.float32))
            kh, kw, sh, sw, ph, pw = cls._resolve_same_pad(mod, "conv")
            conv = (pbwire.field_varint(1, mod.n_output_plane) +
                    pbwire.field_varint(2, int("bias" in p)) +
                    pbwire.field_varint(5, mod.n_group) +
                    pbwire.field_varint(9, ph) +
                    pbwire.field_varint(10, pw) +
                    pbwire.field_varint(11, kh) +
                    pbwire.field_varint(12, kw) +
                    pbwire.field_varint(13, sh) +
                    pbwire.field_varint(14, sw))
            ctx.ch, ctx.spatial = mod.n_output_plane, True
            return ctx.layer("Convolution", [bottom], blobs,
                             pbwire.field_bytes(106, conv))
        if isinstance(mod, nn.SpatialFullConvolution):
            if mod.n_group != 1:
                raise ValueError("Deconvolution with group > 1 unsupported")
            # ours (kh, kw, in, out) -> caffe (in, out, kh, kw)
            w = np.transpose(np.asarray(p["weight"], np.float32),
                             (2, 3, 0, 1))
            blobs = [w]
            if "bias" in p:
                blobs.append(np.asarray(p["bias"], np.float32))
            kh, kw, sh, sw, ph, pw = cls._resolve_same_pad(mod, "deconv")
            conv = (pbwire.field_varint(1, mod.n_output_plane) +
                    pbwire.field_varint(2, int("bias" in p)) +
                    pbwire.field_varint(9, ph) +
                    pbwire.field_varint(10, pw) +
                    pbwire.field_varint(11, kh) +
                    pbwire.field_varint(12, kw) +
                    pbwire.field_varint(13, sh) +
                    pbwire.field_varint(14, sw))
            ctx.ch, ctx.spatial = mod.n_output_plane, True
            return ctx.layer("Deconvolution", [bottom], blobs,
                             pbwire.field_bytes(106, conv))
        if isinstance(mod, (nn.BatchNormalization,)):
            if s is None:
                raise ValueError(
                    "CaffePersister: BatchNormalization needs running stats"
                    " — pass state= (or save a built model)")
            mean = np.asarray(s["running_mean"], np.float32)
            var = np.asarray(s["running_var"], np.float32)
            bn_extra = pbwire.field_bytes(
                139, pbwire.field_float(3, mod.eps))
            top = ctx.layer("BatchNorm", [bottom],
                            [mean, var, np.ones(1, np.float32)], bn_extra)
            ctx.ch = mod.n_output
            if mod.affine:
                sc_extra = pbwire.field_bytes(
                    142, pbwire.field_varint(4, 1))
                top = ctx.layer("Scale", [top],
                                [np.asarray(p["weight"], np.float32),
                                 np.asarray(p["bias"], np.float32)],
                                sc_extra)
            return top
        if isinstance(mod, nn.Scale):
            if len(mod.size) != 1:
                raise ValueError("caffe Scale persists 1-D (per-channel) "
                                 "sizes only")
            sc_extra = pbwire.field_bytes(142, pbwire.field_varint(4, 1))
            return ctx.layer("Scale", [bottom],
                             [np.asarray(p["weight"], np.float32),
                              np.asarray(p["bias"], np.float32)], sc_extra)
        if isinstance(mod, nn.Linear):
            w = np.asarray(p["weight"], np.float32)
            c = ctx.flat_ch
            if c and w.shape[1] % c == 0:
                # our columns are NHWC-flat (H,W,C); caffe wants (C,H,W)
                w = _fc_cols_hwc_to_chw(w, c)
            blobs = [w]
            if "bias" in p:
                blobs.append(np.asarray(p["bias"], np.float32))
            extra = pbwire.field_bytes(
                117, pbwire.field_varint(1, mod.output_size) +
                pbwire.field_varint(2, int("bias" in p)))
            ctx.ch, ctx.spatial, ctx.flat_ch = mod.output_size, False, None
            return ctx.layer("InnerProduct", [bottom], blobs, extra)
        if isinstance(mod, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
            is_max = isinstance(mod, nn.SpatialMaxPooling)
            if getattr(mod, "global_pooling", False):
                pool = (pbwire.field_varint(1, 0 if is_max else 1) +
                        pbwire.field_varint(12, 1))
                return ctx.layer("Pooling", [bottom],
                                 extra=pbwire.field_bytes(103, pool))
            kh, kw, sh, sw, ph, pw = cls._resolve_same_pad(mod, "pooling")
            ceil = getattr(mod, "ceil_mode", False)
            pool = (pbwire.field_varint(1, 0 if is_max else 1) +
                    pbwire.field_varint(5, kh) +
                    pbwire.field_varint(6, kw) +
                    pbwire.field_varint(7, sh) +
                    pbwire.field_varint(8, sw) +
                    pbwire.field_varint(9, ph) +
                    pbwire.field_varint(10, pw) +
                    pbwire.field_varint(13, 0 if ceil else 1))
            return ctx.layer("Pooling", [bottom],
                             extra=pbwire.field_bytes(103, pool))
        if isinstance(mod, nn.ReLU):
            return ctx.layer("ReLU", [bottom])
        if isinstance(mod, nn.Tanh):
            return ctx.layer("TanH", [bottom])
        if isinstance(mod, nn.Sigmoid):
            return ctx.layer("Sigmoid", [bottom])
        if isinstance(mod, nn.Abs):
            return ctx.layer("AbsVal", [bottom])
        if isinstance(mod, nn.SoftPlus):
            return ctx.layer("BNLL", [bottom])
        if isinstance(mod, nn.Exp):
            return ctx.layer("Exp", [bottom])
        if isinstance(mod, nn.Log):
            return ctx.layer("Log", [bottom])
        if isinstance(mod, nn.LogSoftMax):
            # caffe has no LogSoftmax: Softmax followed by a Log layer
            top = ctx.layer("Softmax", [bottom])
            return ctx.layer("Log", [top])
        if isinstance(mod, nn.SoftMax):
            return ctx.layer("Softmax", [bottom])
        if isinstance(mod, nn.Power):
            extra = pbwire.field_bytes(
                122, pbwire.field_float(1, mod.power) +
                pbwire.field_float(2, mod.scale) +
                pbwire.field_float(3, mod.shift))
            return ctx.layer("Power", [bottom], extra=extra)
        if isinstance(mod, nn.MulConstant):
            extra = pbwire.field_bytes(
                122, pbwire.field_float(1, 1.0) +
                pbwire.field_float(2, float(mod.constant)) +
                pbwire.field_float(3, 0.0))
            return ctx.layer("Power", [bottom], extra=extra)
        if isinstance(mod, nn.Dropout):
            extra = pbwire.field_bytes(108, pbwire.field_float(1, mod.p))
            return ctx.layer("Dropout", [bottom], extra=extra)
        if isinstance(mod, nn.SpatialCrossMapLRN):
            lrn = (pbwire.field_varint(1, mod.size) +
                   pbwire.field_float(2, mod.alpha) +
                   pbwire.field_float(3, mod.beta) +
                   pbwire.field_float(5, mod.k))
            return ctx.layer("LRN", [bottom],
                             extra=pbwire.field_bytes(118, lrn))
        if isinstance(mod, (nn.Reshape, nn.InferReshape, nn.View)):
            size = (getattr(mod, "size", None)
                    or getattr(mod, "sizes", None) or ())
            if len(size) == 4 and size[0] == 0:  # (0,H,W,C) batch-preserving
                size = size[1:]
            if len(size) == 3:  # reshape to NHWC spatial -> caffe (0,C,H,W)
                h, w, c = size
                dims = b"".join(pbwire.field_varint(1, int(d))
                                for d in (0, c, h, w))
                extra = pbwire.field_bytes(133, pbwire.field_bytes(1, dims))
                ctx.ch, ctx.spatial = c, True
                return ctx.layer("Reshape", [bottom], extra=extra)
            if ctx.spatial:
                ctx.flat_ch = ctx.ch
            ctx.spatial = False
            return ctx.layer("Flatten", [bottom])
        raise ValueError(
            f"CaffePersister: unsupported layer {type(mod).__name__}"
            " (reference also persisted a fixed layer set)")


def save_caffe(model, params, path: str, state=None,
               prototxt_path: str = None):
    """(reference: Module.saveCaffe via CaffePersister)."""
    return CaffePersister.save(model, params, path, state=state,
                               prototxt_path=prototxt_path)
