"""Torch7 binary serialization (.t7) reader/writer.

Counterpart of ``bigdl_tpu/interop/torchfile.py``: the same codec; the
module loader builds on the device the caller names (the CUDA device by
default; it raises without one), and the saver reads a module's own
leaves where it is given no params tree.

Reference: utils/TorchFile.scala:67 (load :79, save :95; type tags
`TorchObject:42`) — BigDL reads/writes Torch7 objects so models round-trip
with Lua Torch.  The .t7 wire format (public, from torch7/File.lua):

    every value is [i32 type-tag][payload]:
      0 TYPE_NIL
      1 TYPE_NUMBER   f64
      2 TYPE_STRING   i32 len + bytes
      3 TYPE_TABLE    i32 index, then i32 count + count*(key, value)
      4 TYPE_TORCH    i32 index, then version string ("V <n>"), class name
                      string, then class-specific payload
      5 TYPE_BOOLEAN  i32 (0/1)
      6/7/8 FUNCTION variants (unsupported here)

    indices implement reference sharing: the second occurrence of a
    table/object writes only its index.

    torch.XTensor payload: i32 ndim, i64[ndim] size, i64[ndim] stride,
      i64 storageOffset (1-based), then the Storage object (or nil).
    torch.XStorage payload: i64 size, size * element bytes.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, Optional

import numpy as np

__all__ = ["load_t7", "save_t7", "T7Writer", "T7Reader"]

TYPE_NIL, TYPE_NUMBER, TYPE_STRING, TYPE_TABLE, TYPE_TORCH, TYPE_BOOLEAN = \
    0, 1, 2, 3, 4, 5

_TENSOR_CLASSES = {
    "torch.FloatTensor": ("torch.FloatStorage", np.float32),
    "torch.DoubleTensor": ("torch.DoubleStorage", np.float64),
    "torch.IntTensor": ("torch.IntStorage", np.int32),
    "torch.LongTensor": ("torch.LongStorage", np.int64),
    "torch.ByteTensor": ("torch.ByteStorage", np.uint8),
}
_STORAGE_DTYPES = {storage: dtype
                   for storage, dtype in _TENSOR_CLASSES.values()}


class T7Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def _i32(self) -> int:
        return struct.unpack("<i", self.f.read(4))[0]

    def _i64(self) -> int:
        return struct.unpack("<q", self.f.read(8))[0]

    def _f64(self) -> float:
        return struct.unpack("<d", self.f.read(8))[0]

    def _string(self) -> str:
        n = self._i32()
        return self.f.read(n).decode("latin-1")

    def read(self) -> Any:
        tag = self._i32()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            v = self._f64()
            return int(v) if v == int(v) else v
        if tag == TYPE_STRING:
            return self._string()
        if tag == TYPE_BOOLEAN:
            return bool(self._i32())
        if tag == TYPE_TABLE:
            idx = self._i32()
            if idx in self.memo:
                return self.memo[idx]
            out: Dict[Any, Any] = {}
            self.memo[idx] = out
            count = self._i32()
            for _ in range(count):
                k = self.read()
                v = self.read()
                out[k] = v
            # Lua arrays: 1..n integer keys -> python list
            n = len(out)
            if n and all(isinstance(k, int) for k in out) and \
                    set(out) == set(range(1, n + 1)):
                lst = [out[i] for i in range(1, n + 1)]
                self.memo[idx] = lst
                return lst
            return out
        if tag == TYPE_TORCH:
            idx = self._i32()
            if idx in self.memo:
                return self.memo[idx]
            version = self._string()
            if version.startswith("V "):
                cls = self._string()
            else:  # legacy: no version record
                cls = version
            obj = self._read_torch(cls, idx)
            return obj
        raise ValueError(f"unsupported t7 type tag {tag}")

    def _read_torch(self, cls: str, idx: int) -> Any:
        if cls in _TENSOR_CLASSES:
            ndim = self._i32()
            size = [self._i64() for _ in range(ndim)]
            stride = [self._i64() for _ in range(ndim)]
            offset = self._i64() - 1
            storage = self.read()
            if storage is None:
                arr = np.zeros(size, dtype=_TENSOR_CLASSES[cls][1])
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=size,
                    strides=[s * storage.itemsize for s in stride]).copy()
            self.memo[idx] = arr
            return arr
        if cls in _STORAGE_DTYPES:
            dtype = _STORAGE_DTYPES[cls]
            n = self._i64()
            arr = np.frombuffer(
                self.f.read(n * np.dtype(dtype).itemsize), dtype=dtype)
            self.memo[idx] = arr
            return arr
        # unknown torch class: its payload is a table of fields
        payload = self.read()
        obj = {"__torch_class__": cls, **(payload or {})} \
            if isinstance(payload, dict) else \
            {"__torch_class__": cls, "value": payload}
        self.memo[idx] = obj
        return obj


class T7Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self._next_index = 1
        self._seen: Dict[int, int] = {}
        # keep written objects alive: _seen is keyed by id(), which CPython
        # reuses once an object is collected — a dangling id would alias two
        # distinct tables into one shared reference record
        self._keepalive: list = []

    def _i32(self, v: int):
        self.f.write(struct.pack("<i", v))

    def _i64(self, v: int):
        self.f.write(struct.pack("<q", v))

    def _f64(self, v: float):
        self.f.write(struct.pack("<d", v))

    def _string(self, s: str):
        b = s.encode("latin-1")
        self._i32(len(b))
        self.f.write(b)

    def write(self, obj: Any):
        if obj is None:
            self._i32(TYPE_NIL)
        elif isinstance(obj, bool):
            self._i32(TYPE_BOOLEAN)
            self._i32(int(obj))
        elif isinstance(obj, (int, float)):
            self._i32(TYPE_NUMBER)
            self._f64(float(obj))
        elif isinstance(obj, str):
            self._i32(TYPE_STRING)
            self._string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, (list, tuple)):
            self.write({i + 1: v for i, v in enumerate(obj)})
        elif isinstance(obj, dict) and "__torch_class__" in obj:
            key = id(obj)
            self._i32(TYPE_TORCH)
            if key in self._seen:
                self._i32(self._seen[key])
                return
            idx = self._next_index
            self._next_index += 1
            self._seen[key] = idx
            self._keepalive.append(obj)
            self._i32(idx)
            self._string("V 1")
            self._string(obj["__torch_class__"])
            self.write({k: v for k, v in obj.items()
                        if k != "__torch_class__"})
        elif isinstance(obj, dict):
            self._i32(TYPE_TABLE)
            key = id(obj)
            if key in self._seen:
                self._i32(self._seen[key])
                return
            idx = self._next_index
            self._next_index += 1
            self._seen[key] = idx
            self._keepalive.append(obj)
            self._i32(idx)
            self._i32(len(obj))
            for k, v in obj.items():
                self.write(k)
                self.write(v)
        else:
            raise TypeError(f"cannot serialize {type(obj).__name__} to t7")

    def _write_tensor(self, arr: np.ndarray):
        cls = {np.dtype(np.float32): "torch.FloatTensor",
               np.dtype(np.float64): "torch.DoubleTensor",
               np.dtype(np.int32): "torch.IntTensor",
               np.dtype(np.int64): "torch.LongTensor",
               np.dtype(np.uint8): "torch.ByteTensor"}.get(arr.dtype)
        if cls is None:
            arr = arr.astype(np.float32)
            cls = "torch.FloatTensor"
        storage_cls = _TENSOR_CLASSES[cls][0]
        arr = np.ascontiguousarray(arr)
        self._i32(TYPE_TORCH)
        idx = self._next_index
        self._next_index += 1
        self._i32(idx)
        self._string("V 1")
        self._string(cls)
        self._i32(arr.ndim)
        for s in arr.shape:
            self._i64(s)
        itemsize = arr.itemsize
        for s in arr.strides:
            self._i64(s // itemsize)
        self._i64(1)  # storageOffset, 1-based
        # storage object
        self._i32(TYPE_TORCH)
        sidx = self._next_index
        self._next_index += 1
        self._i32(sidx)
        self._string("V 1")
        self._string(storage_cls)
        self._i64(arr.size)
        self.f.write(arr.tobytes())


def load_t7(path: str) -> Any:
    """(reference: TorchFile.load, utils/TorchFile.scala:79)."""
    with open(path, "rb") as f:
        return T7Reader(f).read()


def load_torch_module(path: str, device=None):
    """Map a serialized Lua-Torch nn model to a port module with weights,
    built on ``device`` (default the CUDA device) (reference:
    Module.loadTorch, nn/Module.scala:45 + the per-class readers in
    TorchFile.scala).  Covers the common feed-forward classes; returns
    (module, params_list) like the caffe/tf loaders."""
    import torch

    from ..common import resolve_device
    from ..utils.convert import to_reference_tree
    device = resolve_device(device)
    obj = load_t7(path)
    from .. import nn as N
    from .caffe import _fc_cols_chw_to_hwc

    # Torch activations are NCHW; ours are NHWC.  Track channels so FC
    # weights crossing a conv->flatten boundary get their columns permuted
    # from (C,H,W) to (H,W,C) order, and 3-D reshapes get transposed
    # (round-1 advisor finding — mirrors the CaffeLoader handling).
    ctx = {"ch": None, "spatial": False, "flat_ch": None}

    def convert(o):
        cls = o.get("__torch_class__", "") if isinstance(o, dict) else ""
        if cls == "nn.Sequential":
            seq = N.Sequential()
            mods, ps = [], []
            for child in o.get("modules", []):
                m, p = convert(child)
                if m is not None:
                    seq.add(m)
                    ps.append(p)
            return seq, ps
        if cls == "nn.Linear":
            w = np.asarray(o["weight"], np.float32)
            b = o.get("bias")
            c = ctx["flat_ch"]
            if c and w.shape[1] % c == 0:
                w = _fc_cols_chw_to_hwc(w, c)
            m = N.Linear(w.shape[1], w.shape[0], with_bias=b is not None)
            p = {"weight": w}
            if b is not None:
                p["bias"] = np.asarray(b, np.float32).reshape(-1)
            ctx.update(ch=w.shape[0], spatial=False, flat_ch=None)
            return m, p
        if cls in ("nn.SpatialConvolution", "nn.SpatialConvolutionMM"):
            n_out = int(o["nOutputPlane"])
            n_in = int(o["nInputPlane"])
            kw, kh = int(o["kW"]), int(o["kH"])
            dw, dh = int(o.get("dW", 1)), int(o.get("dH", 1))
            pw, ph = int(o.get("padW", 0)), int(o.get("padH", 0))
            w = np.asarray(o["weight"], np.float32).reshape(
                n_out, n_in, kh, kw)
            b = o.get("bias")
            m = N.SpatialConvolution(n_in, n_out, kw, kh, dw, dh, pw, ph,
                                     with_bias=b is not None)
            p = {"weight": np.transpose(w, (2, 3, 1, 0))}
            if b is not None:
                p["bias"] = np.asarray(b, np.float32).reshape(-1)
            ctx.update(ch=n_out, spatial=True)
            return m, p
        if cls == "nn.SpatialMaxPooling":
            m = N.SpatialMaxPooling(int(o["kW"]), int(o["kH"]),
                                    int(o.get("dW", o["kW"])),
                                    int(o.get("dH", o["kH"])),
                                    int(o.get("padW", 0)),
                                    int(o.get("padH", 0)))
            if o.get("ceil_mode"):
                m.ceil()
            return m, {}
        if cls == "nn.SpatialAveragePooling":
            return N.SpatialAveragePooling(
                int(o["kW"]), int(o["kH"]),
                int(o.get("dW", o["kW"])), int(o.get("dH", o["kH"])),
                int(o.get("padW", 0)), int(o.get("padH", 0))), {}
        simple = {"nn.ReLU": N.ReLU, "nn.Tanh": N.Tanh,
                  "nn.Sigmoid": N.Sigmoid, "nn.SoftMax": N.SoftMax,
                  "nn.LogSoftMax": N.LogSoftMax, "nn.Identity": N.Identity}
        if cls in simple:
            return simple[cls](), {}
        if cls == "nn.Dropout":
            return N.Dropout(float(o.get("p", 0.5))), {}
        if cls in ("nn.Reshape", "nn.View"):
            size = o.get("size")
            dims = [int(s) for s in np.asarray(size).ravel()] \
                if size is not None else [-1]
            if len(dims) == 3:  # torch (C,H,W) -> our NHWC (H,W,C)
                c, h, w_ = dims
                ctx.update(ch=c, spatial=True)
                return N.Reshape((h, w_, c)), {}
            if ctx["spatial"]:
                ctx["flat_ch"] = ctx["ch"]
            ctx["spatial"] = False
            return N.Reshape(tuple(dims)), {}
        raise ValueError(f"load_torch_module: unsupported class {cls!r}")

    module, params = convert(obj)
    module.build(device, torch.Generator().manual_seed(0))
    _, state = to_reference_tree(module)
    module.attach(params, state)
    return module, params


def save_t7(obj: Any, path: str) -> None:
    """(reference: TorchFile.save, utils/TorchFile.scala:95)."""
    with open(path, "wb") as f:
        T7Writer(f).write(obj)


def save_torch_module(module, params, path: str) -> None:
    """Serialize a port module as a Lua-Torch nn object tree
    (reference: Module.saveTorch via TorchFile.save); ``params`` None: the
    module's own (``to_reference_tree``)."""
    from .. import nn as N
    from .caffe import _fc_cols_hwc_to_chw, _own_trees

    params, _ = _own_trees(module, params, {})

    ctx = {"ch": None, "spatial": False, "flat_ch": None}

    def convert(mod, p):
        cls = type(mod).__name__
        if isinstance(mod, N.Sequential):
            return {"__torch_class__": "nn.Sequential",
                    "modules": [convert(m, pp)
                                for m, pp in zip(mod.layers, p)]}
        if isinstance(mod, N.Linear):
            w = np.asarray(p["weight"], np.float32)
            c = ctx["flat_ch"]
            if c and w.shape[1] % c == 0:
                # our columns are NHWC-flat (H,W,C); torch wants (C,H,W)
                w = _fc_cols_hwc_to_chw(w, c)
            o = {"__torch_class__": "nn.Linear", "weight": w}
            if "bias" in p:
                o["bias"] = np.asarray(p["bias"], np.float32)
            ctx.update(ch=mod.output_size, spatial=False, flat_ch=None)
            return o
        if isinstance(mod, N.SpatialConvolution):
            kh, kw = mod.kernel
            sh, sw = mod.stride
            ph, pw = mod.pad
            if ph == -1 or pw == -1:  # SAME sentinel (see CaffePersister)
                if (sh, sw) == (1, 1) and kh % 2 == 1 and kw % 2 == 1:
                    ph, pw = kh // 2, kw // 2
                else:
                    raise ValueError(
                        "save_torch_module: SAME padding (pad=-1) with "
                        f"stride {mod.stride} has no Torch equivalent")
            w = np.transpose(np.asarray(p["weight"], np.float32),
                             (3, 2, 0, 1))  # HWIO -> OIHW
            o = {"__torch_class__": "nn.SpatialConvolution",
                 "nInputPlane": mod.n_input_plane,
                 "nOutputPlane": mod.n_output_plane,
                 "kW": kw, "kH": kh, "dW": sw, "dH": sh,
                 "padW": pw, "padH": ph, "weight": w}
            if "bias" in p:
                o["bias"] = np.asarray(p["bias"], np.float32)
            ctx.update(ch=mod.n_output_plane, spatial=True)
            return o
        if isinstance(mod, N.SpatialMaxPooling):
            kh, kw = mod.kernel
            sh, sw = mod.stride
            ph, pw = mod.pad
            return {"__torch_class__": "nn.SpatialMaxPooling",
                    "kW": kw, "kH": kh, "dW": sw, "dH": sh,
                    "padW": pw, "padH": ph,
                    "ceil_mode": bool(mod.ceil_mode)}
        simple = {"ReLU": "nn.ReLU", "Tanh": "nn.Tanh",
                  "Sigmoid": "nn.Sigmoid", "SoftMax": "nn.SoftMax",
                  "LogSoftMax": "nn.LogSoftMax", "Identity": "nn.Identity"}
        if cls in simple:
            return {"__torch_class__": simple[cls]}
        if isinstance(mod, N.Dropout):
            return {"__torch_class__": "nn.Dropout", "p": mod.p}
        if isinstance(mod, (N.Reshape, N.View)):
            size = tuple(getattr(mod, "size", None)
                         or getattr(mod, "sizes", ()))
            if len(size) == 3:  # our NHWC (H,W,C) -> torch (C,H,W)
                h, w_, c = size
                ctx.update(ch=c, spatial=True)
                return {"__torch_class__": "nn.Reshape",
                        "size": np.asarray((c, h, w_), np.int64)}
            if ctx["spatial"]:
                ctx["flat_ch"] = ctx["ch"]
            ctx["spatial"] = False
            return {"__torch_class__": "nn.Reshape",
                    "size": np.asarray(size, np.int64)}
        raise ValueError(f"save_torch_module: unsupported {cls}")

    save_t7(convert(module, params), path)
