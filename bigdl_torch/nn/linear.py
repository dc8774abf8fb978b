"""Dense and elementwise-parameter layers: ``Linear`` (nn/Linear.scala),
``Bilinear``, ``CMul``, ``CAdd``, ``Mul``, ``Add``, ``MulConstant`` and
``AddConstant``.

Counterpart of ``bigdl_tpu/nn/linear.py``.  The product is a plain matrix
product left to the library, as the reference leaves it to XLA.  The
elementwise layers keep float32 parameters, as the reference does.
"""

from __future__ import annotations

import math

import torch

from ..common import get_policy
from .initialization import compute_fans, default_bias_init, default_weight_init
from .module import Module

__all__ = ["Linear", "Bilinear", "CMul", "CAdd", "Mul", "Add", "MulConstant",
           "AddConstant", "matmul_f32"]


def _mm_f32(a2: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a2[M, K] @ b[K, N] of one dtype, accumulated and returned in
    float32.  On CUDA that is one cuBLAS call with a float32 output; on the
    CPU the operands widen exactly to float32 first, which computes the
    same products."""
    if a2.dtype == torch.float32:
        return a2 @ b
    if a2.device.type == "cuda":
        return torch.mm(a2, b, out_dtype=torch.float32)
    return a2.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(..., out_dtype=float32)`` has no derivative, so the
    product carries its own: each gradient is a product in the operands'
    dtype with float32 accumulation, cast to that dtype."""

    @staticmethod
    def forward(ctx, a2, b):
        ctx.save_for_backward(a2, b)
        return _mm_f32(a2, b)

    @staticmethod
    def backward(ctx, g):
        a2, b = ctx.saved_tensors
        g = g.to(a2.dtype)
        ga = _mm_f32(g, b.t()).to(a2.dtype) if ctx.needs_input_grad[0] \
            else None
        gb = _mm_f32(a2.t(), g).to(b.dtype) if ctx.needs_input_grad[1] \
            else None
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[..., K] @ b[K, N]`` accumulated and returned in float32, for
    operands in one dtype: the reference's ``dot_general(...,
    preferred_element_type=float32)``.  bfloat16 operands keep their
    rounding; only the sum is float32.  Differentiable."""
    if a.dtype == torch.float32:
        return a @ b
    a2 = a.reshape(-1, a.shape[-1])
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        out = _MatmulF32.apply(a2, b)
    else:
        # no gradient wanted: skip the Function, whose per-call cost shows
        # in serving's launch-bound forward (about 1.5 ms of 6 on the card)
        out = _mm_f32(a2, b)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class Linear(Module):
    """y = x W^T + b with weight (out, in).  x and W are cast to the compute
    dtype and multiplied with float32 accumulation; the bias is added in
    float32 before the cast back to the compute dtype."""

    PARAM_ROLES = {"weight": "kernel_out", "bias": "bias"}
    #: used only as its cast to the compute dtype (parallel/mesh_plan.py)
    COMPUTE_CAST = ("weight",)

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        # gradient terms the Optimizer adds (optim/regularizer.py)
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer

    def _init(self, generator):
        shape = (self.output_size, self.input_size)
        fi, fo = compute_fans(shape)
        dt = get_policy().param_dtype
        winit = self.weight_initializer or default_weight_init
        binit = self.bias_initializer or default_bias_init
        p = {"weight": winit(generator, shape, fi, fo, dt)}
        if self.with_bias:
            p["bias"] = binit(generator, (self.output_size,), fi, fo, dt)
        return p

    def forward(self, x):
        c = get_policy().compute_dtype
        tp = self.__dict__.get("_tp")
        if tp is not None:
            # the weight is this rank's rows (output features) of the
            # tensor-parallel split (parallel/mesh_plan.py): the partial
            # input gradients add up over tp, the output features gather
            y = tp.gather(tp.matmul(tp.enter(x), x.to(c),
                                    self.weight.to(c).t()), -1)
        else:
            y = matmul_f32(x.to(c), self.weight.to(c).t())
        if self.with_bias:
            y = y + self.bias
        return y.to(c)


def uniform_f32(generator, shape, stdv):
    """U(-stdv, stdv) in float32, the elementwise layers' init."""
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -stdv, stdv, generator=generator)


class Bilinear(Module):
    """y_k = x1^T W_k x2 + b_k on input [x1, x2] (nn/Bilinear.scala)."""

    PARAM_ROLES = {"weight": "kernel_out", "bias": "bias"}

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True):
        super().__init__()
        self.input_size1, self.input_size2 = input_size1, input_size2
        self.output_size = output_size
        self.bias_res = bias_res

    def _init(self, generator):
        stdv = 1.0 / math.sqrt(self.input_size1)
        p = {"weight": uniform_f32(generator, (self.output_size,
                                            self.input_size1,
                                            self.input_size2), stdv)}
        if self.bias_res:
            p["bias"] = uniform_f32(generator, (self.output_size,), stdv)
        return p

    def forward(self, inputs):
        x1, x2 = inputs[0], inputs[1]
        dt = torch.promote_types(torch.promote_types(x1.dtype, x2.dtype),
                                 self.weight.dtype)
        y = torch.einsum("bi,kij,bj->bk", x1.to(dt), self.weight.to(dt),
                         x2.to(dt))
        if self.bias_res:
            y = y + self.bias
        return y


class CMul(Module):
    """A learnable ``size``-shaped scale, broadcast over the batch
    (nn/CMul.scala)."""

    PARAM_ROLES = {"weight": "elementwise"}

    def __init__(self, size):
        super().__init__()
        self.size = tuple(size)

    def _init(self, generator):
        return {"weight": uniform_f32(generator, self.size,
                                   1.0 / math.sqrt(math.prod(self.size)))}

    def forward(self, x):
        return x * self.weight


class CAdd(Module):
    """A learnable ``size``-shaped bias (nn/CAdd.scala)."""

    PARAM_ROLES = {"bias": "elementwise"}

    def __init__(self, size):
        super().__init__()
        self.size = tuple(size)

    def _init(self, generator):
        return {"bias": uniform_f32(generator, self.size,
                                 1.0 / math.sqrt(math.prod(self.size)))}

    def forward(self, x):
        return x + self.bias


class Mul(Module):
    """One learnable scalar gain (nn/Mul.scala)."""

    PARAM_ROLES = {"weight": "scalar"}

    def _init(self, generator):
        return {"weight": uniform_f32(generator, (), 1.0)}

    def forward(self, x):
        # a 0-d parameter promotes x as JAX promotes it (bf16 -> float32)
        return x.to(torch.promote_types(x.dtype, self.weight.dtype)) * \
            self.weight


class Add(Module):
    """A learnable bias over the feature axis (nn/Add.scala)."""

    PARAM_ROLES = {"bias": "bias"}

    def __init__(self, input_size: int):
        super().__init__()
        self.input_size = input_size

    def _init(self, generator):
        return {"bias": uniform_f32(generator, (self.input_size,),
                                 1.0 / math.sqrt(self.input_size))}

    def forward(self, x):
        return x + self.bias


class MulConstant(Module):
    """x * constant (nn/MulConstant.scala); ``inplace`` is accepted for the
    reference's signature, the output is a new tensor."""

    def __init__(self, constant_scalar: float, inplace: bool = False):
        super().__init__()
        self.constant = constant_scalar

    def forward(self, x):
        return x * self.constant


class AddConstant(Module):
    """x + constant (nn/AddConstant.scala)."""

    def __init__(self, constant_scalar: float, inplace: bool = False):
        super().__init__()
        self.constant = constant_scalar

    def forward(self, x):
        return x + self.constant
