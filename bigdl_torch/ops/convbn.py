"""Conv(1x1) -> BatchNorm with the statistics in the matrix product's
epilogue: a hand-written CUDA kernel for Hopper, its plain PyTorch version,
and the fused training functions as autograd Functions.

Counterpart of ``bigdl_tpu/ops/convbn.py``.  A 1x1 stride-1 convolution
over NHWC is a matrix product over the flattened rows, so
:func:`matmul_stats` (B5, ``_mm_stats_kernel``) returns y = x @ w (+ bias)
in x's dtype together with the per-column float32 (Σy, Σy²) taken from the
float32 accumulator: the BN that follows needs no pass over y for its
statistics.  The wrapper computes :func:`matmul_stats_reference` for CPU
tensors and launches ``bigdl_torch/csrc/matmul_stats.cu`` on CUDA tensors,
or raises.  :func:`route` picks the kernel from dtype, shapes and
alignment, before the launch: ``"tc"`` (bf16 a tensor map can describe:
wgmma fed by TMA), ``"mma_sync"`` (other bf16) or ``"f32"`` (float32 on
the CUDA cores).  ``matmul_stats.launches`` counts every launch and
``matmul_stats.route_launches`` each route's.

:func:`fused_conv_bn_train` and :func:`fused_conv_bn_add_relu_train` port
the reference's custom VJPs (``:186-327``): the forward is B5 and then the
normalize (and residual add and ReLU) as elementwise PyTorch ops in y's
dtype; the backward is the grad-stat kernel (B4, ``ops/batchnorm.py``),
the elementwise dy in y's dtype, and dx = dy·wᵀ, dw = xᵀ·dy as library
matrix products (jnp outside any kernel in the reference).  The conv-bias
gradient is zero (a bias before BN moves only the mean), and the ReLU mask
is recomputed from (y, resid) in the backward rather than stored.

With a process ``group`` (the Engine's data group on the data-parallel
path) they are sync-BN, as the reference's ``axis_name`` route
(``:194-197``, ``:222-227``): B5's (Σy, Σy²) and B4's (Σdy, Σdy·x̂) are
all-reduced over the group, each as one packed buffer, the statistics and
dx use the global row count, and dγ, dβ (like dw) stay this rank's sums
for the Optimizer's average over ranks.

Under ``Optimizer.set_remat("conv_out")`` B5's (y, Σy, Σy²) are the
tensors kept for the backward (``utils/remat.py`` ``conv_out``): the
recompute takes them back and launches no B5; under ``"full"`` it
launches B5 again.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..utils import flops, remat
from .batchnorm import all_reduce_pair, bn_grad_stats, global_rows

__all__ = ["matmul_stats", "matmul_stats_reference", "route",
           "fused_conv_bn_train", "fused_conv_bn_add_relu_train", "ROW_TILE"]

_ROUTE_CODE = {"f32": 0, "mma_sync": 1, "tc": 2}
#: rows per block of every route's kernel (``BM`` in matmul_stats.cu)
ROW_TILE = 128


def route(x2, w2) -> str:
    """The kernel that takes x2 [R, K] @ w2 [K, C] on the card: ``"tc"``
    where tensor maps can describe both (bf16, 16-byte aligned bases, rows
    of K and C elements multiples of 16 bytes), ``"mma_sync"`` for other
    bf16 operands, ``"f32"`` for float32."""
    if x2.dtype == torch.float32:
        return "f32"
    K, C = w2.shape
    aligned = x2.data_ptr() % 16 == 0 and w2.data_ptr() % 16 == 0
    return "tc" if aligned and K % 8 == 0 and C % 8 == 0 else "mma_sync"


def matmul_stats_reference(x2, w2, bias=None):
    """y = x2 @ w2 (+ bias) in float32, returned in x2's dtype, with the
    float32 column sums (Σy, Σy²) of the uncast product."""
    yf = x2.float() @ w2.float()
    if bias is not None:
        yf = yf + bias.float()
    return yf.to(x2.dtype), yf.sum(0), (yf * yf).sum(0)


_launch_lock = threading.Lock()


def _kernel():
    from ..utils import cuda_build

    fn = cuda_build.load("matmul_stats").bigdl_matmul_stats
    if fn.argtypes is None:
        # x, w, bias, y, sum, sumsq, part, route, R, K, C, stream
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x2, w2, bias):
    if x2.dim() != 2 or w2.dim() != 2 or x2.shape[1] != w2.shape[0]:
        raise ValueError(f"matmul_stats: x [R, K] and w [K, C] expected, "
                         f"got {tuple(x2.shape)} and {tuple(w2.shape)}")
    if x2.shape[0] == 0:
        raise ValueError("matmul_stats: R must be > 0")
    if x2.dtype not in (torch.float32, torch.bfloat16) or w2.dtype != x2.dtype:
        raise TypeError(f"matmul_stats takes float32 or bfloat16 x and w of "
                        f"one dtype, got {x2.dtype} and {w2.dtype}")
    operands = [x2, w2] + ([] if bias is None else [bias])
    for t in operands:
        if t.device != x2.device:
            raise ValueError(f"matmul_stats: operands on {t.device} and "
                             f"{x2.device}")
        if not t.is_contiguous():
            raise ValueError("matmul_stats: operands must be contiguous")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (w2.shape[1],)):
        raise ValueError(f"matmul_stats: bias must be float32 "
                         f"[{w2.shape[1]}], got {bias.dtype} "
                         f"{tuple(bias.shape)}")


def matmul_stats(x2, w2, bias=None):
    """(y, Σy, Σy²): y = x2[R, K] @ w2[K, C] (+ bias[C]) with float32
    accumulation, in x2's dtype; the sums are float32 over the rows of the
    product before its cast (B5).  CPU tensors take
    :func:`matmul_stats_reference`.  An open FLOP count
    (``utils/flops.py``) takes 2·R·K·C for it."""
    if flops.COUNTING:
        return flops.kernel(2 * x2.shape[0] * x2.shape[1] * w2.shape[-1],
                            _matmul_stats, x2, w2, bias)
    return _matmul_stats(x2, w2, bias)


def _matmul_stats(x2, w2, bias):
    if x2.device.type == "cpu":
        return matmul_stats_reference(x2, w2, bias)
    if x2.device.type != "cuda":
        raise ValueError(f"matmul_stats: no route for device {x2.device}")
    if bias is not None:
        bias = bias.float().contiguous()
    _check(x2, w2, bias)
    R, K = x2.shape
    C = w2.shape[1]
    f32 = dict(dtype=torch.float32, device=x2.device)
    y = torch.empty((R, C), dtype=x2.dtype, device=x2.device)
    s, ss = torch.empty(C, **f32), torch.empty(C, **f32)
    part = torch.empty(2 * (-(-R // ROW_TILE)) * C, **f32)
    rt = route(x2, w2)
    err = _kernel()(
        x2.data_ptr(), w2.data_ptr(), 0 if bias is None else bias.data_ptr(),
        y.data_ptr(), s.data_ptr(), ss.data_ptr(), part.data_ptr(),
        _ROUTE_CODE[rt], R, K, C,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_stats kernel launch failed ({rt}): CUDA "
                           f"error {err} at {tuple(x2.shape)} x "
                           f"{tuple(w2.shape)} {x2.dtype}")
    with _launch_lock:
        matmul_stats.launches += 1
        matmul_stats.route_launches[rt] += 1
    return y, s, ss


matmul_stats.launches = 0
matmul_stats.route_launches = {"tc": 0, "mma_sync": 0, "f32": 0}


def _stats(s, ss, r, gamma, beta, eps, group):
    if group is not None:
        s, ss = all_reduce_pair(s, ss, "bn_stats", group)
    n = global_rows(r, group)
    mean = s / n
    var = ss / n - mean * mean
    inv = torch.rsqrt(var + eps)
    scale = gamma.float() * inv
    return mean, var, inv, scale, beta.float() - mean * scale


def _normalize(y, scale, shift):
    return y * scale.to(y.dtype) + shift.to(y.dtype)


def _bn_matmul_backward(x2, w2, y, mean, inv, gamma, bias, dz, group,
                        want_dx=True):
    """Backward of (matmul -> training BN) for the BN-output cotangent dz:
    (dx, dw, dbias, dgamma, dbeta), dw, dgamma and dbeta this rank's; dx
    None unless ``want_dx`` (an input that takes no gradient needs no
    product for it)."""
    dz = dz.contiguous()
    sdy_local, sdyx_local = bn_grad_stats(y, dz, mean, inv)
    sdy, sdyx = sdy_local, sdyx_local
    if group is not None:
        sdy, sdyx = all_reduce_pair(sdy, sdyx, "bn_grad_stats", group)
    n = global_rows(y.shape[0], group)
    xhat = (y.float() - mean) * inv
    scale = (gamma.float() * inv).to(y.dtype)
    dy = scale * (dz - (sdy / n).to(y.dtype)
                  - xhat.to(y.dtype) * (sdyx / n).to(y.dtype))
    dx = (dy @ w2.t()).to(x2.dtype) if want_dx else None
    dw = (x2.t().to(dy.dtype) @ dy).to(w2.dtype)
    dbias = None if bias is None else torch.zeros_like(bias)
    return (dx, dw, dbias, sdyx_local.to(gamma.dtype),
            sdy_local.to(gamma.dtype))


class _FusedConvBN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, w2, bias, gamma, beta, eps, group):
        # B5's output is the conv_out a remat recompute takes back
        y, s, ss = remat.conv_out(lambda: matmul_stats(x2, w2, bias))
        mean, var, inv, scale, shift = _stats(s, ss, x2.shape[0], gamma,
                                              beta, eps, group)
        ctx.save_for_backward(x2, w2, y, mean, inv, gamma, bias)
        ctx.mark_non_differentiable(mean, var)
        ctx.group = group
        return _normalize(y, scale, shift), mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        x2, w2, y, mean, inv, gamma, bias = ctx.saved_tensors
        return (*_bn_matmul_backward(x2, w2, y, mean, inv, gamma, bias, dz,
                                     ctx.group, ctx.needs_input_grad[0]),
                None, None)


class _FusedConvBNAddReLU(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, w2, bias, gamma, beta, resid2, eps, group):
        # B5's output is the conv_out a remat recompute takes back
        y, s, ss = remat.conv_out(lambda: matmul_stats(x2, w2, bias))
        mean, var, inv, scale, shift = _stats(s, ss, x2.shape[0], gamma,
                                              beta, eps, group)
        z = torch.clamp_min(_normalize(y, scale, shift) + resid2, 0)
        ctx.save_for_backward(x2, w2, y, mean, inv, gamma, beta, resid2,
                              bias)
        ctx.mark_non_differentiable(mean, var)
        ctx.group = group
        return z.to(y.dtype), mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        x2, w2, y, mean, inv, gamma, beta, resid2, bias = ctx.saved_tensors
        # the ReLU gate recomputed from the forward's own expression
        scale = gamma.float() * inv
        shift = beta.float() - mean * scale
        pre = _normalize(y, scale, shift) + resid2
        dz_m = torch.where(pre > 0, dz, torch.zeros_like(dz))
        dx, dw, dbias, dgamma, dbeta = _bn_matmul_backward(
            x2, w2, y, mean, inv, gamma, bias, dz_m, ctx.group,
            ctx.needs_input_grad[0])
        return (dx, dw, dbias, dgamma, dbeta, dz_m.to(resid2.dtype), None,
                None)


def fused_conv_bn_train(x2, w2, bias, gamma, beta, eps: float, group=None):
    """z = BN_train(x2 @ w2 (+ bias)) over the rows; returns (z, mean, var)
    with mean/var the biased float32 batch statistics (not
    differentiable), over ``group``'s global batch when one is given.
    x2 [R, K] and w2 [K, C] contiguous, one dtype."""
    return _FusedConvBN.apply(x2, w2, bias, gamma, beta, eps, group)


def fused_conv_bn_add_relu_train(x2, w2, bias, gamma, beta, resid2,
                                 eps: float, group=None):
    """z = relu(BN_train(x2 @ w2 (+ bias)) + resid2); returns
    (z, mean, var) as :func:`fused_conv_bn_train` does."""
    return _FusedConvBNAddReLU.apply(x2, w2, bias, gamma, beta, resid2, eps,
                                     group)
