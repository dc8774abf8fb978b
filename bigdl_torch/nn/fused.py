"""Cross-layer fusion: ``ConvBN``, ``ConvBNAddReLU`` and ``fuse_conv_bn``.

Counterpart of ``bigdl_tpu/nn/fused.py``.  ``fuse_conv_bn`` rewrites a
model before ``build``:

- an adjacent (1x1 stride-1 ``SpatialConvolution``,
  ``SpatialBatchNormalization``) pair becomes ``ConvBN``, whose training
  forward is ``ops.convbn.fused_conv_bn_train``: the BN statistics come
  from the matrix product's epilogue (kernel B5), with no pass over the
  conv output to take them;
- a ResNet residual tail, ConcatTable(branch ending in such a pair,
  shortcut) -> CAddTable -> ReLU, becomes ``ConvBNAddReLU``, whose
  training forward is ``ops.convbn.fused_conv_bn_add_relu_train``.

The rewrite nests the pair's param and state entries one level deeper, as
in the reference, so the port's trees line up with the reference's only
when both models are fused before they are built.  In eval mode (and for a
tail whose shortcut does not match the conv's output) the modules compute
their children's unfused composition.
"""

from __future__ import annotations

import torch

from ..common import get_policy
from ..ops.convbn import fused_conv_bn_add_relu_train, fused_conv_bn_train
from .activation import ReLU
from .containers import ConcatTable, Sequential
from .conv import SpatialConvolution
from .module import Container, Module
from .normalization import SpatialBatchNormalization
from .table_ops import CAddTable

__all__ = ["ConvBN", "ConvBNAddReLU", "fuse_conv_bn"]


def _fusable(conv, bn) -> bool:
    return (type(conv) is SpatialConvolution
            and isinstance(bn, SpatialBatchNormalization)
            and conv.kernel == (1, 1) and conv.stride == (1, 1)
            and conv.pad == (0, 0) and conv.n_group == 1
            and bn.affine and bn.sync_axis is None
            and conv.n_output_plane == bn.n_output)


def _operands(conv, x):
    """x as [rows, K] and the 1x1 weight as [K, C], both in the compute
    dtype (the cast the unfused conv makes), and the conv bias."""
    c = get_policy().compute_dtype
    k = x.shape[-1]
    w2 = conv.weight.reshape(k, conv.n_output_plane).to(c)
    bias = conv.bias if conv.with_bias else None
    return x.reshape(-1, k).to(c).contiguous(), w2, bias


class ConvBN(Sequential):
    """Fused 1x1 conv + training-mode BN; children [conv, bn]."""

    def __init__(self, conv: SpatialConvolution,
                 bn: SpatialBatchNormalization):
        if not _fusable(conv, bn):
            raise ValueError(f"ConvBN: ({type(conv).__name__}, "
                             f"{type(bn).__name__}) is not a fusable pair")
        super().__init__(conv, bn)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        conv, bn = self.layers
        x2, w2, bias = _operands(conv, x)
        z2, mean, var = fused_conv_bn_train(x2, w2, bias, bn.weight,
                                            bn.bias, bn.eps)
        bn._ema_update(mean, var, x2.shape[0])
        return z2.reshape(*x.shape[:-1], -1)


class ConvBNAddReLU(Container):
    """Fused residual tail relu(bn(conv(head(x))) + shortcut(x)); children
    [head, conv, bn, shortcut] in param order, ``head`` being the branch
    without its closing (conv, bn) pair."""

    def __init__(self, head: Sequential, conv: SpatialConvolution,
                 bn: SpatialBatchNormalization, shortcut: Module):
        if not _fusable(conv, bn):
            raise ValueError(f"ConvBNAddReLU: ({type(conv).__name__}, "
                             f"{type(bn).__name__}) is not a fusable pair")
        super().__init__(head, conv, bn, shortcut)

    def forward(self, x):
        head, conv, bn, shortcut = self.layers
        h = head(x)
        r = shortcut(x)
        out_shape = (*h.shape[:-1], conv.n_output_plane)
        if not self.training or tuple(r.shape) != out_shape:
            return torch.relu(bn(conv(h)) + r)
        h2, w2, bias = _operands(conv, h)
        r2 = r.reshape(-1, conv.n_output_plane).to(h2.dtype)
        z2, mean, var = fused_conv_bn_add_relu_train(
            h2, w2, bias, bn.weight, bn.bias, r2, bn.eps)
        bn._ema_update(mean, var, h2.shape[0])
        return z2.reshape(out_shape)


def fuse_conv_bn(module: Module) -> Module:
    """Replace every eligible (conv, bn) pair and residual tail inside
    ``module``'s containers, in place; returns ``module``.  Run it before
    ``build``: the rewrite re-nests the fused entries' params."""
    if module.built:
        raise ValueError("fuse_conv_bn must run before build(): the rewrite "
                         "re-nests the fused pairs' param entries, so built "
                         "param trees would no longer line up")
    return _fuse(module)


def _residual_tail(kids, i):
    """ConvBNAddReLU for ConcatTable(branch ... conv1x1, bn; shortcut) ->
    CAddTable -> ReLU at kids[i] (models/resnet.py ``_residual``), or
    None."""
    if i + 2 >= len(kids):
        return None
    ct, add, relu = kids[i], kids[i + 1], kids[i + 2]
    if not (isinstance(ct, ConcatTable) and len(ct.layers) == 2
            and type(add) is CAddTable and type(relu) is ReLU):
        return None
    branch, shortcut = ct.layers
    if not (isinstance(branch, Sequential) and len(branch.layers) >= 2
            and _fusable(branch.layers[-2], branch.layers[-1])):
        return None
    head = _fuse(Sequential(*branch.layers[:-2]))
    return ConvBNAddReLU(head, branch.layers[-2], branch.layers[-1],
                         _fuse(shortcut))


def _fuse(module):
    if isinstance(module, (ConvBN, ConvBNAddReLU)) or \
            not isinstance(module, Container):
        return module
    kids = list(module.layers)
    if isinstance(module, Sequential):
        fused, i = [], 0
        while i < len(kids):
            tail = _residual_tail(kids, i)
            if tail is not None:
                fused.append(tail)
                i += 3
            elif i + 1 < len(kids) and _fusable(kids[i], kids[i + 1]):
                fused.append(ConvBN(kids[i], kids[i + 1]))
                i += 2
            else:
                fused.append(_fuse(kids[i]))
                i += 1
    else:
        fused = [_fuse(m) for m in kids]
    module.layers = torch.nn.ModuleList(fused)
    return module
