"""Weight-only int8 post-training quantization (per output channel,
symmetric).

Counterpart of ``bigdl_tpu/quantize.py``.  :func:`quantize` returns a new
module tree (the float model is untouched) whose matrix-product leaves are
int8 twins: each stores ``q`` (int8) and ``scale`` (float32, one per
output channel) and computes ``product(x, q in the compute dtype) *
scale``; the scale commutes with the contraction because both are linear
per output channel.  The products stay ``torch.matmul`` and cuDNN's
convolution on the dequantized weight, as the reference leaves them to
XLA.  ``QuantMultiHeadAttention`` overrides only the projections, so its
attention is still B6 in a forward and B8 in cached decoding
(``models/decode.py`` calls ``_proj``); under the decode engine's CUDA
graphs the cast of ``q`` runs inside the graph, reading int8 parameters
that stay where they were captured.

The int8 values are the reference's bit for bit: ``scale = amax / 127``
(1 where a channel is all zeros), ``q = clip(round(w / scale), -127,
127)`` in float32, ``round`` half to even in both packages.  The twins
keep the reference's parameter names, so ``utils/convert.py`` carries a
quantized tree across leaf by leaf.  A quantized model is for inference:
its parameters take no gradient, and ``build`` raises rather than draw
float weights over the int8 ones.
"""

from __future__ import annotations

import copy

import torch

from .common import get_policy
from .nn.attention import MultiHeadAttention
from .nn.conv import SpatialConvolution
from .nn.embedding import LookupTable
from .nn.linear import Linear, matmul_f32
from .nn.module import Container, Module

__all__ = ["quantize", "quantize_array", "QuantLinear",
           "QuantSpatialConvolution", "QuantMultiHeadAttention",
           "QuantLookupTable"]


class _NoReinit:
    """Mixin: quantized parameters come only from ``from_float``; a
    rebuild would replace the int8 weights with float ones."""

    def _init(self, generator):
        raise RuntimeError(
            f"{type(self).__name__} cannot be (re)initialized: quantized "
            "modules get their parameters from quantize()/from_float only")


def quantize_array(w, channel_axis: int):
    """Symmetric per-channel int8: (q int8, scale float32 [channels]), on
    ``w``'s device."""
    w = torch.as_tensor(w).detach().to(torch.float32)
    axes = tuple(a for a in range(w.dim()) if a != channel_axis)
    amax = w.abs().amax(dim=axes) if axes else w.abs()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    shape = [1] * w.dim()
    shape[channel_axis] = -1
    q = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127)
    return q.to(torch.int8), scale


def _adopt(module: Module, params) -> Module:
    """Register ``params`` (name -> tensor) as ``module``'s own, in order,
    taking no gradient, and mark it built."""
    for name, t in params.items():
        module.register_parameter(
            name, torch.nn.Parameter(t, requires_grad=False))
    module.param_names = tuple(params)
    module.built = True
    return module


def _geometry(module: Module) -> Module:
    """A copy of ``module``'s configuration without its tensors."""
    geom = copy.copy(module)
    for d in ("_parameters", "_buffers", "_modules"):
        geom.__dict__[d] = {}
    geom.param_names = geom.state_names = ()
    geom.built = False
    return geom


class QuantLinear(_NoReinit, Module):
    """int8 twin of ``nn.Linear`` (weight (out, in), a scale per output
    row)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias

    @classmethod
    def from_float(cls, mod: Linear) -> "QuantLinear":
        m = cls(mod.input_size, mod.output_size, mod.with_bias)
        q, scale = quantize_array(mod.weight, channel_axis=0)
        p = {"q": q, "scale": scale}
        if mod.with_bias:
            p["bias"] = mod.bias.detach().clone()
        return _adopt(m, p)

    def forward(self, x):
        c = get_policy().compute_dtype
        y = matmul_f32(x.to(c), self.q.to(c).t())
        y = (y * self.scale).to(c)
        if self.with_bias:
            y = y + self.bias.to(c)
        return y


class QuantSpatialConvolution(_NoReinit, Module):
    """int8 twin of ``nn.SpatialConvolution`` (HWIO weight, a scale per
    output plane).  The carried ``conv`` keeps the float layer's geometry
    (stride, padding, groups) without its weights; the scale multiplies
    the convolution's output, exact because convolution is linear per
    output plane."""

    def __init__(self, conv: SpatialConvolution):
        super().__init__()
        self.with_bias = conv.with_bias
        geom = _geometry(conv)
        geom.with_bias = False   # the bias is added after the scale
        self.conv = geom

    @classmethod
    def from_float(cls, mod: SpatialConvolution) -> "QuantSpatialConvolution":
        m = cls(mod)
        q, scale = quantize_array(mod.weight, channel_axis=3)  # HWIO
        p = {"q": q, "scale": scale}
        if mod.with_bias:
            p["bias"] = mod.bias.detach().clone()
        return _adopt(m, p)

    def forward(self, x):
        c = get_policy().compute_dtype
        y = self.conv._conv(x, self.q)
        y = (y.to(torch.float32) * self.scale).to(c)
        if self.with_bias:
            y = y + self.bias.to(c)
        return y


class QuantMultiHeadAttention(_NoReinit, MultiHeadAttention):
    """``MultiHeadAttention`` with int8 q, k, v and o projection weights (a
    scale per output column); the attention itself is inherited."""

    @classmethod
    def from_float(cls, mod: MultiHeadAttention) -> "QuantMultiHeadAttention":
        m = cls(mod.embed_dim, mod.num_heads, causal=mod.causal,
                with_bias=mod.with_bias)
        p = {}
        for n in "qkvo":
            q, scale = quantize_array(getattr(mod, "w" + n), channel_axis=1)
            p["w" + n + "_q"] = q
            p["s" + n] = scale
            if mod.with_bias:
                p["b" + n] = getattr(mod, "b" + n).detach().clone()
        return _adopt(m, p)

    def _proj(self, x, name):
        c = get_policy().compute_dtype
        y = matmul_f32(x.to(c), getattr(self, "w" + name + "_q").to(c))
        y = (y * getattr(self, "s" + name)).to(c)
        if self.with_bias:
            y = y + getattr(self, "b" + name).to(c)
        return y


class QuantLookupTable(_NoReinit, Module):
    """int8 embedding table with a scale per row (the rows are the
    channels); its output is in the compute dtype."""

    def __init__(self, lut: LookupTable):
        super().__init__()
        self.lut = _geometry(lut)

    @classmethod
    def from_float(cls, mod: LookupTable) -> "QuantLookupTable":
        q, scale = quantize_array(mod.weight, channel_axis=0)
        return _adopt(cls(mod), {"q": q, "scale": scale})

    def forward(self, x):
        c = get_policy().compute_dtype
        idx = x.long()
        if self.lut.one_based:
            idx = idx - 1
        flat = idx.reshape(-1)
        rows = self.q.index_select(0, flat).to(torch.float32)
        scale = self.scale.index_select(0, flat)
        out = rows * scale[:, None]
        return out.reshape(*idx.shape, self.q.shape[1]).to(c)


_QUANT = (QuantLinear, QuantSpatialConvolution, QuantMultiHeadAttention,
          QuantLookupTable)

_LEAF_RULES = [
    (MultiHeadAttention, QuantMultiHeadAttention),
    (Linear, QuantLinear),
    (SpatialConvolution, QuantSpatialConvolution),
    (LookupTable, QuantLookupTable),
]


def _quantize_node(module: Module) -> Module:
    if isinstance(module, Container):
        clone = _geometry(module)
        clone.built = module.built
        clone.layers = torch.nn.ModuleList(
            [_quantize_node(m) for m in module.layers])
        return clone
    for float_cls, quant_cls in _LEAF_RULES:
        if isinstance(module, float_cls) and not isinstance(module, _QUANT):
            if isinstance(module, SpatialConvolution) and \
                    type(module).__name__ not in ("SpatialConvolution",
                                                  "SpatialShareConvolution"):
                break  # dilated, transposed and mapped geometries stay float
            if isinstance(module, LookupTable) and \
                    module.max_norm is not None:
                break  # a renorm at lookup time has no int8 rows
            return quant_cls.from_float(module)
    return copy.deepcopy(module)


def quantize(model: Module) -> Module:
    """Weight-only int8 post-training quantization: a new module tree
    whose matrix-product leaves hold int8 weights and per-channel scales,
    on the float model's device, used for inference as the float model
    is (forward, ``Predictor``, ``InferenceServer``, ``cached_generate``,
    ``DecodeEngine``)."""
    if not model.built:
        raise ValueError("quantize: build/train the model first (it has "
                         "no parameters)")
    return _quantize_node(model)
